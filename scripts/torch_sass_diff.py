#!/usr/bin/env python3
"""Compare the SASS of the port's CUDA sources, built from this checkout and
from another checkout's ``csrc/``, function by function.

    python3 scripts/torch_sass_diff.py --ref DIR/codemix_dense_retrieval_torch/csrc
                                       [--sources bin_scores.cu bin_scores_f16.cu ...]

Builds each source of both trees with the port's nvcc flags
(``ops/kernels.py::NVCC_FLAGS``, one nvcc per source and tree, all started
together) into ``build/sass_diff/``, dumps each library with ``cuobjdump
-sass``, cuts the dump into functions and compares their code after
renaming the anonymous namespace's per-file hash (``_GLOBAL__N__<hash>_``),
which differs between two builds of one text. Prints one JSON line per
source: the functions whose SASS is equal, those that differ, those found
in one tree only, and which of the latter have the same code as a function
of the other tree (``renamed``: a template instance that gained or lost a
parameter); the exit code is 0 either way. Needs the CUDA toolkit (nvcc,
cuobjdump), not a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
DEFAULT_SOURCES = ["bin_scores.cu", "bin_scores_f16.cu", "bin_scores_int8.cu", "bin_scores_f32.cu"]
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def functions(sass: str) -> dict:
    """{function name: its SASS lines} of one ``cuobjdump -sass`` dump, the
    anonymous namespace's hash renamed in names and code alike."""
    out, name = {}, None
    for line in ANON.sub("_ANON_", sass).splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = []
        elif name is not None and line.strip():
            out[name].append(line.strip())
    return out


def main() -> None:
    from codemix_dense_retrieval_torch.ops import kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", type=pathlib.Path, required=True)
    ap.add_argument("--sources", nargs="+", default=DEFAULT_SOURCES)
    args = ap.parse_args()
    nvcc = kernels._nvcc()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    work = REPO / "build" / "sass_diff"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    trees = {"new": kernels.CSRC, "ref": args.ref}
    procs = {}
    for tree, csrc in trees.items():
        for src in args.sources:
            lib = work / f"{tree}_{src}.so"
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", str(lib), str(csrc / src)]
            procs[tree, src] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                      text=True))
    dumps = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        dumps[key] = functions(subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                                              check=True).stdout)
    for src in args.sources:
        new, ref = dumps["new", src], dumps["ref", src]
        both = sorted(new.keys() & ref.keys())
        only_new, only_ref = sorted(new.keys() - ref.keys()), sorted(ref.keys() - new.keys())
        ref_by_code = {tuple(ref[f]): f for f in only_ref}
        print("[sass] " + json.dumps({
            "source": src,
            "equal": [f for f in both if new[f] == ref[f]],
            "differ": [f for f in both if new[f] != ref[f]],
            "only_new": only_new,
            "only_ref": only_ref,
            "renamed": [[f, ref_by_code[tuple(new[f])]] for f in only_new if tuple(new[f]) in ref_by_code],
        }), flush=True)


if __name__ == "__main__":
    main()
