#!/usr/bin/env python3
"""Time the PyTorch port's bin-major kernels (A: bin scores, 7: sketch
upper-bound bin maxima) against the same C entry points built from another
checkout's ``csrc/``, in one process on one CUDA card.

    python3 scripts/torch_kernel_ab.py [--ref DIR/codemix_dense_retrieval_torch/csrc]
                                       [--variant NAME OLD NEW ...] [--rows N] [--reps R]

Builds this checkout's kernels (and, with ``--ref``, that directory's
``bin_scores.cu`` into ``build/kernel_ab/``), prints ptxas's report for each
(registers, spill bytes, serialised wgmma), holds each kernel against its
plain PyTorch version at small edge shapes, then times the libraries at the
main path's shapes (kernel A: B=256, d=1024, G=8, f32 scores; kernel 7:
B=256, ds=128, G=8) with CUDA events, in turns: ref, new, variants, then
the same in reverse. ``--variant NAME OLD NEW`` (repeatable) builds an
ablation: this checkout's ``bin_scores.cu`` with the text OLD replaced by
NEW (it must occur), e.g. a store made conditional on a value that never
occurs; variants are timed, and their edge errors printed, not checked.
One JSON line per phase; the card's name and power limit come first.
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


def say(tag, **fields):
    print(f"[{tag}] " + json.dumps(fields, default=float), flush=True)


def build_lib(name: str, csrc: pathlib.Path, kernels) -> subprocess.Popen:
    """Start nvcc on ``csrc/bin_scores.cu`` into build/kernel_ab/lib<name>.so."""
    out = REPO / "build" / "kernel_ab" / f"lib{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(csrc / "bin_scores.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_lib(name: str, proc: subprocess.Popen, kernels) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    rep = kernels.ptxas_report(log)
    say(f"ptxas_{name}", warnings=rep["warnings"], serialized=rep["serialized"],
        max_registers=max(v["registers"] for v in rep["kernels"].values()),
        spill_bytes=sum(v["spill_bytes"] for v in rep["kernels"].values()))
    return ctypes.CDLL(str(REPO / "build" / "kernel_ab" / f"lib{name}.so"))


def entry_points(lib, topk, sketch):
    a = lib.bin_scores_launch
    a.argtypes, a.restype = topk._BIN_SCORES_ARGTYPES, ctypes.c_int
    u = lib.binub_launch
    u.argtypes, u.restype = sketch._BINUB_ARGTYPES, ctypes.c_int
    return a, u


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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    work = REPO / "build" / "kernel_ab"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    procs = {}
    if args.ref is not None:
        procs["ref"] = build_lib("ref", args.ref, kernels)
    for name, old, new in args.variant:
        src = work / name
        shutil.copytree(kernels.CSRC, src, ignore=shutil.ignore_patterns("build"))
        text = (src / "bin_scores.cu").read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: text not found: {old!r}")
        (src / "bin_scores.cu").write_text(text.replace(old, new))
        procs[name] = build_lib(name, src, kernels)
    kernels.build_kernels(["bin_scores"])
    rep = kernels.ptxas_report(kernels.build_log("bin_scores"))
    say("ptxas_new", warnings=rep["warnings"], serialized=rep["serialized"],
        kernels={k[-60:]: v for k, v in rep["kernels"].items()})
    libs = {"new": entry_points(kernels.load("bin_scores"), topk, sketch)}
    for name, proc in procs.items():
        libs[name] = entry_points(finish_lib(name, proc, kernels), topk, sketch)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream

    def run_a(fn, q, d, s, bm, nv, G, bf16=False):
        rc = fn(q.data_ptr(), d.data_ptr(), s.data_ptr(), bm.data_ptr(), None, nv,
                q.shape[0], d.shape[0], d.shape[1], G, 1, int(bf16), stream)
        kernels.check(rc, "bin_scores")

    def run_u(fn, qs, qt, ds, dt, out, nv, G):
        rc = fn(qs.data_ptr(), qt.data_ptr(), ds.data_ptr(), dt.data_ptr(), out.data_ptr(), None, nv,
                qs.shape[0], ds.shape[0], qs.shape[1], G, stream)
        kernels.check(rc, "binub")

    # edge shapes against the plain versions
    errs = {}
    for name, (fa, fu) in libs.items():
        worst_a = worst_u = 0.0
        for b, n, d, nv, G in ((1, 4096, 96, 1000, 8), (130, 8192, 1024, 8000, 16),
                               (257, 4096, 128, 4000, 8)):
            q = torch.randn(b, d, device=dev, generator=g).to(torch.bfloat16)
            docs = torch.randn(n, d, device=dev, generator=g).to(torch.bfloat16)
            s = torch.empty(b, n, device=dev)
            bm = torch.empty(b, n // G, device=dev)
            run_a(fa, q, docs, s, bm, nv, G)
            s2, bm2 = topk.bin_scores_plain(q, docs, nv, G)
            torch.cuda.synchronize()
            worst_a = max(worst_a, (s - s2).abs().max().item(), (bm - bm2).abs().max().item())
            qt = torch.rand(b, device=dev, generator=g)
            dt = torch.rand(n, device=dev, generator=g)
            out = torch.empty(b, n // G, device=dev)
            run_u(fu, q, qt, docs, dt, out, nv, G)
            out2 = sketch.binub_plain(q, qt, docs, dt, G, nv)
            torch.cuda.synchronize()
            worst_u = max(worst_u, ((out - out2).abs() / out2.abs().clamp_min(1.0)).max().item())
        errs[name] = {"A_max_abs": worst_a, "binub_max_rel": worst_u}
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
    times_a = [(k, ms(lambda: run_a(libs[k][0], q, docs, s, bm, n - 417, 8), args.reps)) for k in order]
    del docs, s
    torch.cuda.empty_cache()
    qs = (torch.randn(256, 128, device=dev, generator=g) * 0.1).to(torch.bfloat16)
    ds = (torch.randn(n, 128, device=dev, generator=g) * 0.1).to(torch.bfloat16)
    qt = torch.rand(256, device=dev, generator=g)
    dt = torch.rand(n, device=dev, generator=g)
    times_u = [(k, ms(lambda: run_u(libs[k][1], qs, qt, ds, dt, bm, n - 417, 8), 4 * args.reps))
               for k in order]
    say("main_shape_ms", rows=n, A_B256_d1024_G8_f32=times_a, binub_B256_ds128_G8=times_u, card=smi)


if __name__ == "__main__":
    main()
