#!/usr/bin/env python3
"""Time the PyTorch port's bin-score kernels against the same C entry points
built from another checkout's ``csrc/``, in one process on one CUDA card:
kernel A (bin scores, bin-major), kernel 5 (bin maxima only), kernel 7
(sketch upper-bound bin maxima) and kernel 4 (int8 bin scores, both
layouts).

    python3 scripts/torch_kernel_ab.py [--ref DIR/codemix_dense_retrieval_torch/csrc]
                                       [--variant NAME OLD NEW ...] [--rows N] [--reps R]

Builds this checkout's ``bin_scores.cu`` and ``bin_scores_int8.cu`` (and,
with ``--ref``, that directory's two sources into ``build/kernel_ab/``),
prints ptxas's report for each (registers, spill bytes, serialised wgmma),
holds each kernel against its plain PyTorch version at small edge shapes,
then times the libraries at the main path's shapes (kernels A and 5: B=256,
d=1024, G=8, f32 scores; kernel 7: B=256, ds=128, G=8; kernel 4 bin-major:
B=256, d=1024, G=8; kernel 4 transposed: B=256, N=131,072, d=1024, G=16)
with CUDA events, in turns: ref, new, variants, then the same in reverse.
``--variant NAME OLD NEW`` (repeatable) builds an ablation: this checkout's
``csrc/`` with the text OLD replaced by NEW in every source that holds it (at
least one must), e.g. a store made conditional on a value that never occurs;
variants are timed, and their edge errors printed, not checked. One JSON
line per phase; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SOURCES = {"": "bin_scores.cu", "_int8": "bin_scores_int8.cu"}


def say(tag, **fields):
    print(f"[{tag}] " + json.dumps(fields, default=float), flush=True)


def build_libs(name: str, csrc: pathlib.Path, kernels) -> list:
    """Start nvcc on ``csrc``'s two sources into build/kernel_ab/lib<name>[_int8].so."""
    procs = []
    for suffix, source in SOURCES.items():
        out = REPO / "build" / "kernel_ab" / f"lib{name}{suffix}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(csrc / source)]
        procs.append((out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_libs(name: str, procs: list, kernels) -> list:
    libs = []
    for out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
        rep = kernels.ptxas_report(log)
        say(f"ptxas_{out.stem}", warnings=rep["warnings"], serialized=rep["serialized"],
            max_registers=max(v["registers"] for v in rep["kernels"].values()),
            spill_bytes=sum(v["spill_bytes"] for v in rep["kernels"].values()))
        libs.append(ctypes.CDLL(str(out)))
    return libs


def entry_points(lib, lib8, topk, sketch):
    """(kernel A / 2, kernel 5, kernel 7, kernel 4) C entries of a library pair."""
    fns = []
    for l, name, argtypes in ((lib, "bin_scores_launch", topk._BIN_SCORES_ARGTYPES),
                              (lib, "binmax_only_launch", topk._BINMAX_ONLY_ARGTYPES),
                              (lib, "binub_launch", sketch._BINUB_ARGTYPES),
                              (lib8, "bin_scores_int8_launch", topk._BIN_SCORES_INT8_ARGTYPES)):
        fn = getattr(l, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns.append(fn)
    return fns


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", type=pathlib.Path, default=None)
    ap.add_argument("--variant", nargs=3, action="append", default=[], metavar=("NAME", "OLD", "NEW"))
    ap.add_argument("--rows", type=int, default=8_842_240)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA card")
    from codemix_dense_retrieval_torch.ops import kernels, sketch, topk
    from codemix_dense_retrieval_torch.ops.quant import quantize_rows

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    work = REPO / "build" / "kernel_ab"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    procs = {}
    if args.ref is not None:
        procs["ref"] = build_libs("ref", args.ref, kernels)
    for name, old, new in args.variant:
        src = work / name
        shutil.copytree(kernels.CSRC, src, ignore=shutil.ignore_patterns("build"))
        hits = 0
        for path in src.iterdir():
            text = path.read_text()
            if old in text:
                path.write_text(text.replace(old, new))
                hits += 1
        if not hits:
            raise SystemExit(f"variant {name}: text not found: {old!r}")
        procs[name] = build_libs(name, src, kernels)
    kernels.build_kernels(["bin_scores", "bin_scores_int8"])
    for lib_name in ("bin_scores", "bin_scores_int8"):
        rep = kernels.ptxas_report(kernels.build_log(lib_name))
        say(f"ptxas_new_{lib_name}", warnings=rep["warnings"], serialized=rep["serialized"],
            kernels={k[-60:]: v for k, v in rep["kernels"].items()})
    libs = {"new": entry_points(kernels.load("bin_scores"), kernels.load("bin_scores_int8"), topk, sketch)}
    for name, ps in procs.items():
        libs[name] = entry_points(*finish_libs(name, ps, kernels), topk, sketch)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream

    def run_a(fn, q, d, s, bm, nv, G, bin_major=True, bf16=False):
        rc = fn(q.data_ptr(), d.data_ptr(), s.data_ptr(), bm.data_ptr(), None, nv,
                q.shape[0], d.shape[0], d.shape[1], G, int(bin_major), int(bf16), stream)
        kernels.check(rc, "bin_scores")

    def run_5(fn, q, d, bm, nv, G):
        rc = fn(q.data_ptr(), d.data_ptr(), bm.data_ptr(), None, nv, q.shape[0], d.shape[0], d.shape[1],
                G, stream)
        kernels.check(rc, "binmax_only")

    def run_u(fn, qs, qt, ds, dt, out, nv, G):
        rc = fn(qs.data_ptr(), qt.data_ptr(), ds.data_ptr(), dt.data_ptr(), out.data_ptr(), None, nv,
                qs.shape[0], ds.shape[0], qs.shape[1], G, stream)
        kernels.check(rc, "binub")

    def run_4(fn, q8, qs8, d8, ds8, s, bm, nv, G, bin_major):
        rc = fn(q8.data_ptr(), qs8.data_ptr(), d8.data_ptr(), ds8.data_ptr(), s.data_ptr(), bm.data_ptr(),
                None, nv, q8.shape[0], d8.shape[0], d8.shape[1], G, int(bin_major), 0, stream)
        kernels.check(rc, "bin_scores_int8")

    # edge shapes against the plain versions
    errs = {}
    for name, (fa, f5, fu, f4) in libs.items():
        worst = {"A_max_abs": 0.0, "binmax_only_max_abs": 0.0, "binub_max_rel": 0.0, "int8_bits_differ": 0}
        for b, n, d, nv, G in ((1, 4096, 192, 1000, 8), (130, 8192, 1024, 8000, 16),
                               (257, 4096, 128, 4000, 8), (65, 4096, 64, 100, 16)):
            q = torch.randn(b, d, device=dev, generator=g).to(torch.bfloat16)
            docs = torch.randn(n, d, device=dev, generator=g).to(torch.bfloat16)
            s = torch.empty(b, n, device=dev)
            bm = torch.empty(b, n // G, device=dev)
            run_a(fa, q, docs, s, bm, nv, G)
            s2, bm2 = topk.bin_scores_plain(q, docs, nv, G)
            torch.cuda.synchronize()
            worst["A_max_abs"] = max(worst["A_max_abs"], (s - s2).abs().max().item(),
                                     (bm - bm2).abs().max().item())
            run_5(f5, q, docs, bm, nv, G)
            torch.cuda.synchronize()
            worst["binmax_only_max_abs"] = max(worst["binmax_only_max_abs"], (bm - bm2).abs().max().item())
            qt = torch.rand(b, device=dev, generator=g)
            dt = torch.rand(n, device=dev, generator=g)
            run_u(fu, q, qt, docs, dt, bm, nv, G)
            out2 = sketch.binub_plain(q, qt, docs, dt, G, nv)
            torch.cuda.synchronize()
            worst["binub_max_rel"] = max(worst["binub_max_rel"],
                                         ((bm - out2).abs() / out2.abs().clamp_min(1.0)).max().item())
            q8, qs8 = quantize_rows(q.float())
            d8, ds8 = quantize_rows(docs.float())
            for bin_major in (True, False):
                s8 = torch.empty((b, n) if bin_major else (n, b), device=dev)
                bm8 = torch.empty((b, n // G) if bin_major else (n // G, b), device=dev)
                run_4(f4, q8, qs8, d8, ds8, s8, bm8, nv, G, bin_major)
                s82, bm82 = topk.bin_scores_int8_plain(q8, qs8, d8, ds8, nv, G,
                                                       layout="bin_major" if bin_major else "transposed")
                torch.cuda.synchronize()
                worst["int8_bits_differ"] += int((s8 != s82).sum().item() + (bm8 != bm82).sum().item())
        errs[name] = worst
    say("edges", **errs)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    n = args.rows
    names = (["ref"] if "ref" in libs else []) + ["new"] + [v[0] for v in args.variant]
    order = names + names[::-1]
    q = torch.randn(256, 1024, device=dev, generator=g).to(torch.bfloat16)
    docs = torch.empty(n, 1024, device=dev, dtype=torch.bfloat16)
    for r0 in range(0, n, 1 << 20):
        docs[r0:r0 + (1 << 20)] = torch.randn(min(1 << 20, n - r0), 1024, device=dev, generator=g)
    s = torch.empty(256, n, device=dev)
    bm = torch.empty(256, n // 8, device=dev)
    times = {}
    times["A_B256_d1024_G8_f32"] = [(k, ms(lambda: run_a(libs[k][0], q, docs, s, bm, n - 417, 8), args.reps))
                                    for k in order]
    times["binmax_only_B256_d1024_G8"] = [(k, ms(lambda: run_5(libs[k][1], q, docs, bm, n - 417, 8), args.reps))
                                          for k in order]
    # kernel 4 on the rows quantized, one chunk of f32 at a time
    d8 = torch.empty(n, 1024, device=dev, dtype=torch.int8)
    ds8 = torch.empty(n, device=dev)
    for r0 in range(0, n, 1 << 20):
        d8[r0:r0 + (1 << 20)], ds8[r0:r0 + (1 << 20)] = quantize_rows(docs[r0:r0 + (1 << 20)].float())
    del docs
    q8, qs8 = quantize_rows(q.float())
    times["int8_bin_major_B256_d1024_G8_f32"] = [
        (k, ms(lambda: run_4(libs[k][3], q8, qs8, d8, ds8, s, bm, n - 417, 8, True), args.reps)) for k in order]
    ns = 131_072
    st = torch.empty(ns, 256, device=dev)
    bmt = torch.empty(ns // 16, 256, device=dev)
    d8s, ds8s = d8[:ns].contiguous(), ds8[:ns].contiguous()
    times["int8_transposed_B256_N131072_G16_f32"] = [
        (k, ms(lambda: run_4(libs[k][3], q8, qs8, d8s, ds8s, st, bmt, ns - 77, 16, False), 20 * args.reps))
        for k in order]
    del d8, ds8, s
    torch.cuda.empty_cache()
    qs = (torch.randn(256, 128, device=dev, generator=g) * 0.1).to(torch.bfloat16)
    ds = (torch.randn(n, 128, device=dev, generator=g) * 0.1).to(torch.bfloat16)
    qt = torch.rand(256, device=dev, generator=g)
    dt = torch.rand(n, device=dev, generator=g)
    times["binub_B256_ds128_G8"] = [(k, ms(lambda: run_u(libs[k][2], qs, qt, ds, dt, bm, n - 417, 8), 4 * args.reps))
                                    for k in order]
    say("main_shape_ms", rows=n, card=smi, **times)


if __name__ == "__main__":
    main()
