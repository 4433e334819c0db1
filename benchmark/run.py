#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``: its configuration file (``configs[].file``), its traffic file
``benchmark/traffic/<traffic>.json``, the driver that file names
(``benchmark/drivers/<driver>.py``), the model family the configuration
names (``benchmark/families/<family>.py``), the limits of its check
(``benchmark/limits/<cell>.json``) and its per-layer metrics
(``benchmark/metrics/<metric>.py``) are all found by name. The last line of
standard output is one JSON object; the last lines of standard error are
the numbers compared against their limits. The run needs a CUDA card and
the port (``codemix_dense_retrieval_torch``) beside this folder; without
either it prints no result and exits with 2, and with JAX or the JAX
package loaded once the window has closed it prints none and exits with 3.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
PORT = "codemix_dense_retrieval_torch"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / PORT).is_dir():
        print(f"[bench] the port ({PORT}/) is not in {ROOT}: no result", file=sys.stderr)
        return 2
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from harness import core

    cell = core.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] the cell needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result", file=sys.stderr)
        return 2
    work = pathlib.Path(tempfile.mkdtemp(prefix="cdr-bench-"))
    # autotune's built-in defaults are measured, never a tuned store
    os.environ["CDR_TUNE_FILE"] = str(work / "untuned" / "tuned.json")
    try:
        ctx = core.Context(cell=cell.name, config=cell.config, traffic=cell.traffic, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace), device=torch.device("cuda", 0),
                           tmp=work, limits=cell.limits)
        result = core.run_cell(ctx, cell)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bad = core.forbidden_loaded()
    if bad:
        print(f"[bench] modules this benchmark may not load are loaded: {bad}: no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
