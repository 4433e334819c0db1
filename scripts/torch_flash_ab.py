#!/usr/bin/env python3
"""Time the PyTorch port's kernel B (``csrc/flash_attention.cu``) against the
same C entry point built from another checkout's ``csrc/`` and from
text-patched variants, in one process on one CUDA card, beside SDPA.

    python3 scripts/torch_flash_ab.py [--ref DIR/codemix_dense_retrieval_torch/csrc]
                                      [--variant NAME OLD NEW ...] [--reps R]

Builds this checkout's ``flash_attention.cu`` (and, with ``--ref``, that
directory's, into ``build/flash_ab/``), prints ptxas's report for each
(registers, spill bytes, serialised wgmma), holds each library against
``attention_flash_plain`` at every Qwen3 length bucket (S = 16 .. 1024,
dh = 128, 16 q heads over 8 KV heads, causal: ragged lengths, packed rows
with segment ids whose pad rows must be 0, full lengths) and at BGE-M3's
shapes (dh = 64, 16 heads, non-causal S = 1024 and packed S = 512), then
times them with CUDA events in turns (ref, new, variants, then the same in
reverse) at Qwen3's buckets (B = 128 queries to S = 256, B = 32 passages at
512 and 1024; full and ragged lengths) and BGE-M3's two shapes, with SDPA
(``is_causal=True``, KV heads repeated) and each shape's bound. ``--variant
NAME OLD NEW`` (repeatable) builds this checkout's source with the text OLD
replaced by NEW (several pairs: OLD and NEW split at "@@"). One JSON line
per phase; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TOL = 2e-2
QWEN = dict(h=16, kvh=8, dh=128, causal=True)
BGE = dict(h=16, kvh=16, dh=64, causal=False)


def say(tag, **fields):
    print(f"[{tag}] " + json.dumps(fields, default=float), flush=True)


def main() -> None:
    import ctypes

    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", type=pathlib.Path, default=None)
    ap.add_argument("--variant", nargs=3, action="append", default=[], metavar=("NAME", "OLD", "NEW"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_ab: no CUDA card")
    from codemix_dense_retrieval_torch.ops import flash_attention as fa
    from codemix_dense_retrieval_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    work = REPO / "build" / "flash_ab"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    sources = {}
    if args.ref is not None:
        sources["ref"] = args.ref
    for name, old, new in args.variant:
        src = work / name
        shutil.copytree(kernels.CSRC, src, ignore=shutil.ignore_patterns("build"))
        text = (src / "flash_attention.cu").read_text()
        olds, news = old.split("@@"), new.split("@@")
        if len(olds) != len(news):
            raise SystemExit(f"variant {name}: {len(olds)} texts to replace, {len(news)} replacements")
        for o, n_ in zip(olds, news):
            if o not in text:
                raise SystemExit(f"variant {name}: text not found: {o!r}")
            text = text.replace(o, n_)
        (src / "flash_attention.cu").write_text(text)
        sources[name] = src
    procs = {}
    for name, src in sources.items():
        out = work / f"lib{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src / "flash_attention.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernels.build_kernels(["flash_attention"])
    fns = {"new": fa._flash_lib()}
    logs = {"new": kernels.build_log("flash_attention")}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out)).flash_attention_launch
        fn.argtypes, fn.restype = fa._FLASH_ARGTYPES, ctypes.c_int
        fns[name] = fn
        logs[name] = log
    for name, log in logs.items():
        rep = kernels.ptxas_report(log)
        say(f"ptxas_{name}", serialized=rep["serialized"], warnings=rep["warnings"], kernels=rep["kernels"])

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(14)
    rng = np.random.default_rng(14)

    def run(name, q, k, v, lens, causal, seg=None):
        saved = fa._flash_lib
        fa._flash_lib = lambda: fns[name]
        try:
            return fa.attention_flash(q, k, v, lens, causal=causal, segment_ids=seg)
        finally:
            fa._flash_lib = saved

    def qkv(b, s, h, kvh, dh, **_):
        return [torch.randn(b, s, n, dh, device=dev, generator=g).to(torch.bfloat16).transpose(1, 2)
                for n in (h, kvh, kvh)]

    def packed_segments(b, s):
        seg = np.zeros((b, s), np.int32)
        for r in range(b):
            pos, sid, fill = 0, 1, s if r == 0 else int(rng.integers(1, s + 1))
            while pos < fill:
                n_ = min(int(rng.integers(1, max(2, s // 4) + 1)), fill - pos)
                seg[r, pos:pos + n_] = sid
                pos, sid = pos + n_, sid + 1
        return torch.from_numpy(seg).to(dev)

    # accuracy: every library at every bucket
    cases = []
    for s in (16, 64, 128, 256, 512, 1024):
        t = qkv(8, s, **QWEN)
        lens_r = rng.integers(1, s + 1, 8).astype(np.int32)
        lens_r[0] = s
        seg = packed_segments(8, s)
        cases += [(f"qwen3_S{s}_ragged", t, torch.from_numpy(lens_r).to(dev), True, None),
                  (f"qwen3_S{s}_packed", t, (seg > 0).sum(dim=1, dtype=torch.int32), True, seg),
                  (f"qwen3_S{s}_full", t, torch.full((8,), s, dtype=torch.int32, device=dev), True, None)]
    t = qkv(4, 1024, **BGE)
    cases.append(("bge_S1024_ragged", t, torch.tensor([1024, 1000, 700, 129], dtype=torch.int32, device=dev),
                  False, None))
    seg = packed_segments(4, 512)
    cases.append(("bge_S512_packed", qkv(4, 512, **BGE), (seg > 0).sum(dim=1, dtype=torch.int32), False, seg))
    errs = {}
    for label, (q, k, v), lens, causal, seg in cases:
        want = fa.attention_flash_plain(q.float(), k.float(), v.float(), lens, causal=causal, segment_ids=seg)
        for name in fns:
            got = run(name, q, k, v, lens, causal, seg)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            if seg is not None and not bool((got[(seg == 0)[:, None, :, None].expand_as(got)] == 0).all()):
                err = float("inf")
            errs.setdefault(name, {})[label] = err
    say("accuracy", tolerance=TOL, worst={n: max(e.values()) for n, e in errs.items()}, errors=errs)
    bad = [n for n in ("new", "ref") if n in errs and max(errs[n].values()) > TOL]
    if bad:
        raise SystemExit(f"torch_flash_ab: {bad} outside {TOL} of the plain version")

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

    names = list(fns)
    order = names + names[::-1]
    shapes = [("qwen3", s, 128 if s <= 256 else 32) for s in (16, 64, 128, 256, 512, 1024)]
    shapes += [("bge", 1024, 32), ("bge_packed", 512, 32)]
    rows = []
    for family, s, b in shapes:
        cfg = QWEN if family == "qwen3" else BGE
        q, k, v = qkv(b, s, **cfg)
        h, kvh, dh, causal = cfg["h"], cfg["kvh"], cfg["dh"], cfg["causal"]
        variants = [("full", torch.full((b,), s, dtype=torch.int32, device=dev), None)]
        if family == "qwen3":
            lens = rng.integers(1, s + 1, b).astype(np.int32)
            variants.append(("ragged", torch.from_numpy(lens).to(dev), None))
        if family == "bge_packed":
            seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
            seg[:] = torch.arange(s, device=dev) // (s // 16) + 1
            variants = [("packed16", torch.full((b,), s, dtype=torch.int32, device=dev), seg)]
        reps = max(5, min(400, int(args.reps * (1024 * 32) / (s * b) * (1024 / s))))
        for tag, lens, seg in variants:
            ln = lens.cpu().numpy().astype(np.int64)
            r = np.arange(s)
            if seg is not None:  # 16 equal segments of s / 16 rows
                width = s // 16
                keys = float(b) * 16 * width * (width + 1) / 2 if causal else float(b) * s * width
            elif causal:
                keys = float(np.minimum(r[None, :] + 1, ln[:, None]).sum())
            else:
                keys = float(s * ln.sum())
            ops = 4.0 * h * dh * keys
            nbytes = 2 * b * s * h * dh * 2 + 2 * b * s * kvh * dh * 2
            bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3
            t = {n: [] for n in names}
            for n in order:
                t[n].append(ms(lambda: run(n, q, k, v, lens, causal, seg), reps))
            row = dict(shape=f"{family} B={b} H={h} KVH={kvh} S={s} dh={dh} {tag}"
                             + (" causal" if causal else ""),
                       bound_ms=bound, **{f"{n}_ms": min(x) for n, x in t.items()},
                       spread={n: [min(x), max(x)] for n, x in t.items()})
            if family == "qwen3":
                kr, vr = k.repeat_interleave(h // kvh, dim=1), v.repeat_interleave(h // kvh, dim=1)
                row["sdpa_ms"] = ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kr, vr, is_causal=True), reps)
                del kr, vr
            rows.append(row)
            say("time", reps=reps, **row)
        del q, k, v
    say("summary", card=smi, rows=rows)


if __name__ == "__main__":
    main()
