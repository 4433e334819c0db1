"""Experiment scheduler — the Python replacement for the reference's bash
job schedulers (`run_all_vector_pairs.sh`, `run_ablation.sh`,
`reproduce_en_zh.sh` — SURVEY §2.1 #16-18).

Keeps their operational semantics:

- **job queue** built from a declarative plan (the bash ``BILINGUAL_PAIRS``
  / ``MONO_JOBS`` matrices become a JSON plan file);
- **resume by artifact completeness**: a job is skipped when every
  expected band's run file and ``*-agg.json`` already exist
  (`run_all_vector_pairs.sh:329-360,441-445`);
- **per-device slot table**: each device (a card's name) has a
  capacity; a job occupies one slot on one device and the child is told
  its placement via ``CDR_DEVICE`` (the reference pins ``cuda:<g>`` with
  per-GPU ``GPU<g>_SLOTS`` caps, `run_all_vector_pairs.sh:571-595`);
- **per-type caps**: at most ``type_caps[t]`` jobs of type ``t`` run at
  once (the reference's per-type caps, e.g. one bilingual hub per GPU);
- **fail-fast with process-group kill**: a failed job (beyond
  ``max_failures``) stops the sweep and terminates every running child's
  WHOLE process group — children are spawned in their own sessions, so
  grandchildren die too (`run_all_vector_pairs.sh:502-527,562-566`).

Jobs are CLI commands (the same ``python -m codemix_dense_retrieval_torch``
surface), so per-job logs and restart behavior match the reference.
"""

from __future__ import annotations

import json
import os
import pathlib
import shlex
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from codemix_dense_retrieval_torch.utils.logging import get_logger

log = get_logger("scheduler")


@dataclass
class Job:
    name: str
    argv: List[str]  # CLI arguments after `python -m codemix_dense_retrieval_torch`
    outdir: str
    expected: List[str] = field(default_factory=list)  # artifact glob patterns
    eval_after: List[List[str]] = field(default_factory=list)  # evaluate argv lists
    env: Dict[str, str] = field(default_factory=dict)
    jtype: str = ""  # job type for per-type caps ("bilingual", "mono", ...)
    device: Optional[str] = None  # explicit device pin; None = any free device

    def complete(self) -> bool:
        """Artifact-completeness postcondition (resume semantics)."""
        out = pathlib.Path(self.outdir)
        if not self.expected:
            return False
        for pattern in self.expected:
            if not list(out.glob(pattern)):
                return False
        return True


@dataclass
class SweepResult:
    ran: List[str]
    skipped: List[str]
    failed: List[str]
    placements: Dict[str, str] = field(default_factory=dict)  # job -> device


class Scheduler:
    def __init__(
        self,
        jobs: Sequence[Job],
        *,
        slots: int = 1,
        device_slots: Optional[Dict[str, int]] = None,
        type_caps: Optional[Dict[str, int]] = None,
        max_failures: int = 1,
        python: Optional[str] = None,
        module: str = "codemix_dense_retrieval_torch",
        log_dir: Optional[pathlib.Path] = None,
        poll_interval: float = 0.2,
    ) -> None:
        self.jobs = list(jobs)
        # single-chip default: one device "0" with `slots` capacity
        self.device_slots = dict(device_slots) if device_slots else {"0": max(1, slots)}
        self.type_caps = dict(type_caps) if type_caps else {}
        self.max_failures = max_failures
        self.python = python or sys.executable
        self.module = module
        self.log_dir = pathlib.Path(log_dir) if log_dir else None
        self.poll_interval = poll_interval
        for job in self.jobs:
            if job.device is not None and job.device not in self.device_slots:
                raise ValueError(
                    f"job {job.name} pinned to unknown device {job.device!r}; "
                    f"known: {sorted(self.device_slots)}"
                )

    # -- placement ---------------------------------------------------------

    def _free_device(
        self, job: Job, used: Dict[str, int], type_running: Dict[str, int]
    ) -> Optional[str]:
        """First device with a free slot honoring the job's pin and its
        type cap; None when the job cannot be placed right now."""
        cap = self.type_caps.get(job.jtype)
        if cap is not None and type_running.get(job.jtype, 0) >= cap:
            return None
        candidates = [job.device] if job.device is not None else sorted(self.device_slots)
        for dev in candidates:
            if used.get(dev, 0) < self.device_slots[dev]:
                return dev
        return None

    def _spawn(self, job: Job, device: str) -> subprocess.Popen:
        cmd = [self.python, "-m", self.module, *job.argv]
        log.info("starting job %s on device %s: %s", job.name, device, shlex.join(cmd))
        stdout = subprocess.DEVNULL
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            stdout = open(self.log_dir / f"{job.name}.log", "w")
        env = dict(os.environ)
        env.update(job.env)
        env["CDR_DEVICE"] = device  # the cuda:<g> pin analog
        # own session -> own process group, so fail-fast can kill the whole
        # tree (the reference's process-group kill, run_all_vector_pairs.sh:502-527)
        try:
            return subprocess.Popen(
                cmd, stdout=stdout, stderr=subprocess.STDOUT, env=env,
                start_new_session=True,
            )
        finally:
            if stdout is not subprocess.DEVNULL:
                stdout.close()  # the child holds its own descriptor

    # -- main loop ----------------------------------------------------------

    def run(self, dry_run: bool = False) -> SweepResult:
        queue: List[Job] = []
        skipped: List[str] = []
        for job in self.jobs:
            if job.complete():
                log.info("job %s already complete; skipping (resume)", job.name)
                skipped.append(job.name)
            else:
                queue.append(job)
        if dry_run:
            for job in queue:
                log.info("would run: %s", job.name)
            return SweepResult([j.name for j in queue], skipped, [])

        running: Dict[str, subprocess.Popen] = {}
        job_device: Dict[str, str] = {}
        used: Dict[str, int] = {d: 0 for d in self.device_slots}
        type_running: Dict[str, int] = {}
        job_by_name = {j.name: j for j in queue}
        ran: List[str] = []
        failed: List[str] = []
        placements: Dict[str, str] = {}
        pending = list(queue)

        def release(name: str) -> None:
            dev = job_device.pop(name)
            used[dev] -= 1
            jt = job_by_name[name].jtype
            type_running[jt] = type_running.get(jt, 0) - 1

        try:
            while pending or running:
                # first-fit launch scan (a type-capped job does not block
                # later placeable jobs)
                launched = True
                while launched:
                    launched = False
                    for i, job in enumerate(pending):
                        dev = self._free_device(job, used, type_running)
                        if dev is None:
                            continue
                        pending.pop(i)
                        running[job.name] = self._spawn(job, dev)
                        job_device[job.name] = dev
                        placements[job.name] = dev
                        used[dev] += 1
                        type_running[job.jtype] = type_running.get(job.jtype, 0) + 1
                        launched = True
                        break
                # reap
                done = [n for n, p in running.items() if p.poll() is not None]
                if not done:
                    time.sleep(self.poll_interval)
                    continue
                for name in done:
                    proc = running.pop(name)
                    release(name)
                    job = job_by_name[name]
                    if proc.returncode != 0:
                        log.error("job %s FAILED (rc=%d)", name, proc.returncode)
                        failed.append(name)
                        if len(failed) >= self.max_failures:
                            self._kill_all(running)
                            return SweepResult(ran, skipped, failed, placements)
                        continue
                    # post-run evals (per band, reference `:694-715`)
                    ok = True
                    for eval_argv in job.eval_after:
                        rc = subprocess.call(
                            [self.python, "-m", self.module, *eval_argv]
                        )
                        if rc != 0:
                            ok = False
                            break
                    if ok and (not job.expected or job.complete()):
                        ran.append(name)
                    else:
                        log.error("job %s finished but artifacts incomplete", name)
                        failed.append(name)
                        if len(failed) >= self.max_failures:
                            self._kill_all(running)
                            return SweepResult(ran, skipped, failed, placements)
        except KeyboardInterrupt:
            self._kill_all(running)
            raise
        return SweepResult(ran, skipped, failed, placements)

    @staticmethod
    def _kill_all(running: Dict[str, subprocess.Popen]) -> None:
        """Terminate each child's whole process group (children are session
        leaders), escalating to SIGKILL — never pattern-based."""

        def _signal_group(proc: subprocess.Popen, sig: int) -> None:
            try:
                os.killpg(os.getpgid(proc.pid), sig)
            except (OSError, ProcessLookupError):
                try:
                    proc.send_signal(sig)
                except OSError:
                    pass

        for proc in running.values():
            _signal_group(proc, signal.SIGTERM)
        for proc in running.values():
            try:
                proc.wait(timeout=10)
            except Exception:
                _signal_group(proc, signal.SIGKILL)


def load_plan(path) -> List[Job]:
    """Plan file: {"jobs": [{"name", "argv", "outdir", "expected",
    "eval_after", "env", "type", "device"}...],
    "device_slots": {...}, "type_caps": {...}} — the last two are read by
    :func:`load_plan_options`."""
    data = json.loads(pathlib.Path(path).read_text())
    jobs = []
    for j in data["jobs"]:
        jobs.append(
            Job(
                name=j["name"],
                argv=j["argv"],
                outdir=j["outdir"],
                expected=j.get("expected", []),
                eval_after=j.get("eval_after", []),
                env=j.get("env", {}),
                jtype=j.get("type", ""),
                device=j.get("device"),
            )
        )
    return jobs


def load_plan_options(path) -> Tuple[Optional[Dict[str, int]], Optional[Dict[str, int]]]:
    """(device_slots, type_caps) from a plan file; None when absent."""
    data = json.loads(pathlib.Path(path).read_text())
    return data.get("device_slots"), data.get("type_caps")


def run_sweep_cli(args) -> None:
    jobs = load_plan(args.plan)
    device_slots, type_caps = load_plan_options(args.plan)
    sched = Scheduler(
        jobs,
        max_failures=args.max_failures,
        device_slots=device_slots,
        type_caps=type_caps,
        slots=getattr(args, "slots", 1),
    )
    result = sched.run(dry_run=args.dry_run)
    print(
        json.dumps(
            {"ran": result.ran, "skipped": result.skipped, "failed": result.failed},
            indent=2,
        )
    )
    if result.failed:
        raise SystemExit(1)
