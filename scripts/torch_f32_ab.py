#!/usr/bin/env python3
"""Time the PyTorch port's f32 bin-score kernels (``csrc/bin_scores_f32.cu``:
kernels A, 5, 7 bin-major and 2 transposed, 3xTF32) against the same C entry
points built from another checkout's ``csrc/`` and from text-patched
variants, in one process on one CUDA card.

    python3 scripts/torch_f32_ab.py [--ref DIR/codemix_dense_retrieval_torch/csrc]
                                    [--variant NAME OLD NEW ...] [--rows N] [--reps R]

A library that exports ``tf32_split_launch`` takes its bin-major queries as
their (2, B, d) tf32 split, made by that entry inside the timed call; an
older one takes them as they are. Its transposed entry (kernel 2) takes the
split too, unless its sources still split the operands in shared memory
(``split_stage`` in ``bin_kernels.cuh``), where it takes the queries as
they are. Each library is held against the plain f32 versions at edge
shapes (unit rows; the tolerance is chip_smoke.py's TOL_F32, 2e-6), then
timed with CUDA events in turns (ref, new, variants, then the same in
reverse) at the main path's shapes: kernels A and 5 at B = 256,
N = 8,842,240, d = 1024, G = 8 (f32 scores), kernel 7 at ds = 128, kernel 2
at N = 131,072 and at hubness_stats' N = 20,000, G = 16. One JSON line per
phase; the card's name and power limit come first.
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
TOL_F32 = 2e-6


def say(tag, **fields):
    print(f"[{tag}] " + json.dumps(fields, default=float), flush=True)


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", type=pathlib.Path, default=None)
    ap.add_argument("--variant", nargs=3, action="append", default=[], metavar=("NAME", "OLD", "NEW"))
    ap.add_argument("--rows", type=int, default=8_842_240)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_f32_ab: no CUDA card")
    from codemix_dense_retrieval_torch.ops import kernels, sketch, topk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    work = REPO / "build" / "f32_ab"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    sources = {}
    if args.ref is not None:
        sources["ref"] = args.ref
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
        sources[name] = src
    procs = {}
    for name, src in sources.items():
        out = work / f"lib{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src / "bin_scores_f32.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernels.build_kernels(["bin_scores_f32"])
    libs = {"new": kernels.load("bin_scores_f32")}
    logs = {"new": kernels.build_log("bin_scores_f32")}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
        logs[name] = log
    for name, log in logs.items():
        rep = kernels.ptxas_report(log)
        say(f"ptxas_{name}", serialized=rep["serialized"], kernels=rep["kernels"])

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(14)
    stream = torch.cuda.current_stream().cuda_stream

    def entries(lib):
        fa, f5, f7 = lib.bin_scores_launch, lib.binmax_only_launch, lib.binub_launch
        fa.argtypes, fa.restype = topk._BIN_SCORES_ARGTYPES, ctypes.c_int
        f5.argtypes, f5.restype = topk._BINMAX_ONLY_ARGTYPES, ctypes.c_int
        f7.argtypes, f7.restype = sketch._BINUB_ARGTYPES, ctypes.c_int
        split = None
        if hasattr(lib, "tf32_split_launch"):
            fs = lib.tf32_split_launch
            fs.argtypes, fs.restype = topk._TF32_SPLIT_ARGTYPES, ctypes.c_int

            def split(x):
                out = torch.empty((2, *x.shape), dtype=torch.float32, device=dev)
                kernels.check(fs(x.data_ptr(), out.data_ptr(), x.numel(), stream), "tf32_split")
                return out
        return fa, f5, f7, split

    calls = {name: entries(lib) for name, lib in libs.items()}
    # the libraries whose transposed entry takes the queries unsplit
    raw_transposed = {name for name, src in [("new", kernels.CSRC), *sources.items()]
                      if "split_stage" in (src / "bin_kernels.cuh").read_text()}
    say("query_operands", split_transposed=[n for n in libs if n not in raw_transposed],
        raw_transposed=sorted(raw_transposed))

    def qarg(name, q):
        split = calls[name][3]
        return split(q) if split is not None else q

    def run_a(name, q, d, s, bm, nv, G, bin_major=True):
        qa = qarg(name, q) if bin_major or name not in raw_transposed else q
        rc = calls[name][0](qa.data_ptr(), d.data_ptr(), s.data_ptr(), bm.data_ptr(), None, nv,
                            q.shape[0], d.shape[0], d.shape[1], G, int(bin_major), 0, stream)
        kernels.check(rc, "bin_scores")

    def run_5(name, q, d, bm, nv, G):
        qa = qarg(name, q)
        rc = calls[name][1](qa.data_ptr(), d.data_ptr(), bm.data_ptr(), None, nv, q.shape[0], d.shape[0],
                            d.shape[1], G, stream)
        kernels.check(rc, "binmax_only")

    def run_7(name, qs, qt, ds, dt, out, nv, G):
        qa = qarg(name, qs)
        rc = calls[name][2](qa.data_ptr(), qt.data_ptr(), ds.data_ptr(), dt.data_ptr(), out.data_ptr(), None,
                            nv, qs.shape[0], ds.shape[0], qs.shape[1], G, stream)
        kernels.check(rc, "binub")

    def unit(n, d):
        x = torch.randn(n, d, device=dev, generator=g)
        return x / x.norm(dim=1, keepdim=True)

    # edge shapes against the plain versions (B = 1, 64, 65, 130, 257: every
    # tile size and a ragged last query tile; N = 4,112: a ragged last row tile)
    errs = {}
    for name in libs:
        worst = {"A_bin_major": 0.0, "2_transposed": 0.0, "5": 0.0, "7": 0.0, "split_bits_differ": 0}
        for b, n, d, nv, G in ((1, 4096, 192, 1000, 8), (130, 8192, 1024, 8000, 16),
                               (257, 4096, 128, 4000, 8), (65, 4096, 64, 100, 16),
                               (64, 4112, 96, 4035, 16)):
            q, docs = unit(b, d), unit(n, d)
            s, bm = torch.empty(b, n, device=dev), torch.empty(b, n // G, device=dev)
            run_a(name, q, docs, s, bm, nv, G)
            s2, bm2 = topk.bin_scores_plain(q, docs, nv, G)
            torch.cuda.synchronize()
            worst["A_bin_major"] = max(worst["A_bin_major"], (s - s2).abs().max().item(),
                                       (bm - bm2).abs().max().item())
            st, bmt = torch.empty(n, b, device=dev), torch.empty(n // G, b, device=dev)
            run_a(name, q, docs, st, bmt, nv, G, bin_major=False)
            torch.cuda.synchronize()
            worst["2_transposed"] = max(worst["2_transposed"], (st - s2.T).abs().max().item(),
                                        (bmt - bm2.T).abs().max().item())
            run_5(name, q, docs, bm, nv, G)
            torch.cuda.synchronize()
            worst["5"] = max(worst["5"], (bm - bm2).abs().max().item())
            qt, dt = torch.rand(b, device=dev, generator=g), torch.rand(n, device=dev, generator=g)
            run_7(name, q, qt, docs, dt, bm, nv, G)
            want7 = sketch.binub_plain(q, qt, docs, dt, G, nv)
            torch.cuda.synchronize()
            worst["7"] = max(worst["7"], (bm - want7).abs().max().item())
            if calls[name][3] is not None:
                worst["split_bits_differ"] += int((calls[name][3](q) != topk.tf32_split_plain(q)).sum().item())
        errs[name] = worst
    say("edges", tolerance=TOL_F32, **errs)
    e = errs["new"]
    if max(e["A_bin_major"], e["2_transposed"], e["5"], e["7"]) > TOL_F32 or e["split_bits_differ"]:
        raise SystemExit("torch_f32_ab: the new library is outside TOL_F32 of the plain versions")

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

    names = list(libs)
    order = names + names[::-1]
    n = args.rows
    q = unit(256, 1024)
    docs = torch.empty(n, 1024, device=dev)
    for r0 in range(0, n, 1 << 20):
        docs[r0:r0 + (1 << 20)] = unit(min(1 << 20, n - r0), 1024)
    s = torch.empty(256, n, device=dev)
    bm = torch.empty(256, n // 8, device=dev)
    nv = n - 417
    # kernel A and 5 at the main shape, against the plain version's scores
    run_a("new", q, docs, s, bm, nv, 8)
    worst_main = 0.0
    for r0 in range(0, n, 1 << 20):
        r1 = min(n, r0 + (1 << 20))
        ref_s = (q @ docs[r0:r1].T).masked_fill_(torch.arange(r0, r1, device=dev) >= nv, topk.NEG_INF)
        worst_main = max(worst_main, (s[:, r0:r1] - ref_s).abs().max().item())
    say("main_shape_err", kernel="A f32 (new)", max_abs_err=worst_main, tolerance=TOL_F32)
    times = {}
    times["A_B256_d1024_G8"] = [(k, ms(lambda: run_a(k, q, docs, s, bm, nv, 8), args.reps)) for k in order]
    times["5_B256_d1024_G8"] = [(k, ms(lambda: run_5(k, q, docs, bm, nv, 8), args.reps)) for k in order]
    ns = 131_072
    st, bmt = torch.empty(ns, 256, device=dev), torch.empty(ns // 16, 256, device=dev)
    dsm = docs[:ns].contiguous()
    times["2_B256_N131072_G16"] = [
        (k, ms(lambda: run_a(k, q, dsm, st, bmt, ns - 77, 16, bin_major=False), 20 * args.reps)) for k in order]
    nh = 20_000
    dh = docs[:nh].contiguous()
    sth, bmth = torch.empty(nh, 256, device=dev), torch.empty(nh // 16, 256, device=dev)
    times["2_B256_N20000_G16"] = [
        (k, ms(lambda: run_a(k, q, dh, sth, bmth, nh, 16, bin_major=False), 40 * args.reps)) for k in order]
    del docs, s, dsm, dh
    torch.cuda.empty_cache()
    qs = unit(256, 128) * 0.5
    ds = unit(n, 128) * 0.5
    qt, dt = torch.rand(256, device=dev, generator=g), torch.rand(n, device=dev, generator=g)
    times["7_B256_ds128_G8"] = [(k, ms(lambda: run_7(k, qs, qt, ds, dt, bm, nv, 8), 4 * args.reps))
                                for k in order]
    say("main_shape_ms", rows=n, card=smi,
        **{k: {n_: min(t for m, t in v if m == n_) for n_ in names} for k, v in times.items()},
        turns=times)


if __name__ == "__main__":
    main()
