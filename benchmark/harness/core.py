"""One run of one cell: set-up, the window, the check, the result line.

A driver module (``drivers/<driver>.py``, named by the traffic file) has

- ``setup(ctx) -> state``: make the inputs from the seed, build the port's
  objects through its normal constructors, warm the cell's own shapes;
- ``window(ctx, state) -> dict``: drive the entry for ``ctx.seconds``
  inside ``with ctx.window():``, and return ``e2e`` (end-to-end values),
  ``counters`` (what the per-layer readers read), ``attempted``,
  ``failed``;
- ``check(ctx, state) -> {name: number}``: free the port's state, then
  compare what the window produced with the plain reference.

Per-layer metrics are modules ``metrics/<name>.py`` with ``LAYER`` and
``read(readings) -> number or None``: None leaves the metric out.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from harness.compare import checks_from
from harness.trace import WINDOW_SPAN, Tracer, TraceSummary

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "codemix_dense_retrieval_tpu")


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_of(config: Dict):
    """The model family module (``families/<family>.py``) a configuration names."""
    return load_module(BENCH / "families" / f"{config['family']}.py", f"families.{config['family']}")


def load_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file at {path}")
    return json.loads(path.read_text())


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with every file it names, loaded."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    driver: object
    e2e: List[str]
    per_layer: List[str]
    metrics: Dict[str, object]
    units: Dict[str, str]


def _find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, root: pathlib.Path = BENCH.parent) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration
    (``configs[].file``), traffic (``traffic/<traffic>.json``), driver
    (``drivers/<driver>.py``, named by the traffic), limits
    (``limits/<cell>.json``) and per-layer metrics (``metrics/<metric>.py``),
    each found by name."""
    spec = load_json(root / "BENCHMARK.json")
    cell = _find(spec["workloads"], name, "workload")
    entry = _find(spec["configs"], cell["config"], "configuration")

    def lists(m) -> bool:
        return "workloads" not in m or name in m["workloads"]

    t = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    e2e = {m["name"]: m["unit"] for m in spec["end_to_end"] if lists(m)}
    per_layer = {m["name"]: m["unit"] for m in spec["per_layer"] if lists(m)}
    return Cell(
        name=name, chips=cell["chips"], config=load_json(root / entry["file"]), traffic=t,
        limits=load_json(BENCH / "limits" / f"{name}.json"),
        driver=load_module(BENCH / "drivers" / f"{t['driver']}.py", f"drivers.{t['driver']}"),
        e2e=list(e2e), per_layer=list(per_layer),
        metrics={n: load_module(BENCH / "metrics" / f"{n}.py", f"metrics.{n}") for n in per_layer},
        units={**e2e, **per_layer},
    )


@dataclass
class Readings:
    """What a per-layer reader reads: the window's length, the trace's
    summary, the driver's counters and the cell's configuration."""
    window_s: float
    trace: Optional[TraceSummary]
    counters: Dict
    config: Dict


@dataclass
class Context:
    cell: str
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmp: pathlib.Path
    limits: Dict = field(default_factory=dict)
    variant: Optional[str] = None          # "control": the lower-precision path
    window_s: float = 0.0
    tracer: Optional[Tracer] = None

    def log(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def family(self):
        return family_of(self.config)

    @contextlib.contextmanager
    def window(self):
        """The measured window: profiled when tracing; ``self.window_s``
        holds its length once it closes. Yields a clock: seconds since the
        window opened."""
        self.sync()
        self.tracer = Tracer() if self.trace else None
        with contextlib.ExitStack() as stack:
            if self.tracer is not None:
                stack.enter_context(self.tracer)
            stack.enter_context(torch.profiler.record_function(WINDOW_SPAN))
            t0 = time.perf_counter()
            try:
                yield lambda: time.perf_counter() - t0
            finally:
                self.sync()
                self.window_s = time.perf_counter() - t0


def cuda_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that this benchmark may not load,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def run_cell(ctx: Context, cell: Cell) -> dict:
    """Run the cell once; returns the result object (its ``check`` last)."""
    driver = cell.driver
    t0 = time.perf_counter()
    if ctx.device.type == "cuda":
        torch.empty(1, device=ctx.device)          # the CUDA context: part of set-up
        torch.cuda.reset_peak_memory_stats(ctx.device)
    state = driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t0
    ctx.log(f"setup_s {setup_s!r}")
    out = driver.window(ctx, state)
    peak = cuda_peak(ctx.device)
    ctx.log(f"window_s {ctx.window_s!r} memory_peak_bytes {peak}")
    summary = ctx.tracer.summary() if ctx.tracer is not None else None
    ctx.tracer = None
    if summary is not None:
        ctx.log(f"trace reduced in {summary.reduce_s:.1f} s: busy_s {summary.busy_s!r} of {summary.window_s!r}")
    t1 = time.perf_counter()
    numbers = driver.check(ctx, state)
    ctx.log(f"numbers {numbers!r}")
    del state
    free_device(ctx.device)
    checks = checks_from(numbers, ctx.limits)
    ctx.log(f"check took {time.perf_counter() - t1:.1f} s")

    e2e = dict(out["e2e"], setup_s=setup_s, peak_mem_gib=peak / 2**30)
    if ctx.trace:
        r = Readings(window_s=ctx.window_s, trace=summary, counters=out.get("counters", {}), config=ctx.config)
        values = {name: cell.metrics[name].read(r) for name in cell.per_layer}
    else:
        values = {name: e2e.get(name) for name in cell.e2e}
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": {k: {"value": v, "unit": cell.units[k]} for k, v in values.items() if v is not None},
        "device": device_info(ctx.device, peak, summary),
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops(), "idle_gaps": summary.idle_gaps}
    result["check"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:   # the last lines on standard error
        ctx.log(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}")
    return result


def device_info(device: torch.device, peak: int, summary: Optional[TraceSummary]) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": peak, "power_limit": power_limit(device)}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info


def power_limit(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    if device.type != "cuda":
        return "no card"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"
