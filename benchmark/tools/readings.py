#!/usr/bin/env python3
"""The numbers a cell's check compares, over many seeds, in one process:
the readings its limits are set from.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 11 12 13 \\
        [--variant control] [--fault <name>] [--set key=<json>] [--seconds 5] \\
        [--out chiprun_out/readings.jsonl]

Each seed runs the cell once (set-up, a short window at the cell's own
load, the check) and prints one JSON line: the seed, the variant, every
number the driver compared and the run's end-to-end values. ``--variant
control`` runs the path in the precision below the configuration's (the
int8 store for search, the int8-quantized encoder for encoding): its
numbers are the limits' upper readings. ``--fault`` plants one of the
driver's ``FAULTS`` in the port underneath the timed path, at the cell's
own size. ``--set`` replaces a top-level key of the configuration (a value
in JSON), to try a setting before it goes into the configuration's file.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


class _Numbers:
    """The driver behind a proxy that keeps what its check returned."""

    def __init__(self, driver) -> None:
        self._d = driver
        self.last = None

    def __getattr__(self, name):
        return getattr(self._d, name)

    def check(self, ctx, state):
        self.last = self._d.check(ctx, state)
        return self.last


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variant", default=None, choices=(None, "control"))
    p.add_argument("--fault", default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from harness import core

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        cell.config[key] = json.loads(value)
    if args.fault:
        target, attr, broken = cell.driver.FAULTS[args.fault](cell)
        setattr(target, attr, broken)
    cell.driver = _Numbers(cell.driver)
    for seed in args.seeds:
        work = pathlib.Path(tempfile.mkdtemp(prefix="cdr-readings-"))
        os.environ["CDR_TUNE_FILE"] = str(work / "untuned" / "tuned.json")
        t0 = time.perf_counter()
        try:
            ctx = core.Context(cell=cell.name, config=cell.config, traffic=cell.traffic, seed=seed,
                               seconds=args.seconds, trace=False, device=torch.device("cuda", 0), tmp=work,
                               limits=cell.limits, variant=args.variant)
            result = core.run_cell(ctx, cell)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        line = json.dumps({"workload": cell.name, "seed": seed, "variant": args.variant or "program",
                           "fault": args.fault, "set": args.set,
                           "numbers": cell.driver.last, "correct": result["correct"],
                           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        core.free_device(ctx.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
