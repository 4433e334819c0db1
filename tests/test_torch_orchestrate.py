"""The port's ``orchestrate/`` (plans, scheduler, storage) and its
host-tool subcommands against the JAX package's: ``make-plan`` writes the
same plan JSON byte for byte for all three kinds; the port's ``Scheduler``
keeps the JAX one's slot table, type caps, resume and fail-fast (driven
with ``tests.fake_job``, as the JAX suite drives its own) and spawns
``python -m codemix_dense_retrieval_torch`` by default; the eight new
subcommands take the JAX parser's flags (``analyze`` adds ``--device``);
and one sweep runs end to end on the CPU: ``make-plan en-zh-repro`` ->
``sweep`` -> ``collect`` -> ``paper-values``."""

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import pytest

from codemix_dense_retrieval_torch.cli import build_parser as port_parser
from codemix_dense_retrieval_torch.cli import main as port_main
from codemix_dense_retrieval_torch.orchestrate import plans as port_plans
from codemix_dense_retrieval_torch.orchestrate import scheduler as port_sched
from codemix_dense_retrieval_torch.orchestrate import storage as port_storage
from codemix_dense_retrieval_tpu.cli import build_parser as ref_parser
from codemix_dense_retrieval_tpu.cli import main as ref_main
from codemix_dense_retrieval_tpu.orchestrate import plans as ref_plans
from codemix_dense_retrieval_tpu.orchestrate import storage as ref_storage

REPO = pathlib.Path(__file__).resolve().parents[1]
NEW_COMMANDS = ("generate-bands", "download-queries", "analyze", "make-plan", "sweep", "collect",
                "paper-values", "plots")


# --- plans -------------------------------------------------------------------

def _band_dir(tmp_path):
    bands = tmp_path / "bands"
    bands.mkdir()
    for name in ("cm0", "cm20-40", "cm40-60", "cm100"):
        (bands / f"queries-{name}.tsv").write_text("q1\tx\n")
    return bands


PLAN_CASES = {
    "all_pairs": ["all-pairs", "--index_root", "/ix"],
    "all_pairs_full": ["all-pairs", "--index_root", "/ix", "--qrels", "/qrels.tsv", "--checkpoint", "/ck",
                       "--encoder", "intfloat/multilingual-e5-large", "--size", "8841823", "--k", "1000",
                       "--runner_arg", "--device cpu --smoke_dim 32", "--runner_arg", "--qblock 256"],
    "en_zh_repro": ["en-zh-repro", "--index_root", "/ix", "--qrels", "/qrels.tsv"],
    "en_zh_repro_bands": ["en-zh-repro", "--index_root", "/ix", "--qrels", "/qrels.tsv", "--band_dir", "BANDS",
                          "--checkpoint", "/ck", "--k", "20", "--runner_arg", "--device cpu"],
    "ablation": ["ablation", "--index_root_by_model", "me5-large-instruct=/a", "gte-multilingual-base=/b",
                 "jina-embedding-v3=/c", "qwen3-embedding-0.6B=/d", "qwen3-embedding-4B=/e",
                 "qwen3-embedding-8B=/f", "--checkpoints", "qwen3-embedding-0.6B=/ck", "--qrels", "/q.tsv"],
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_make_plan_json_is_byte_equal(tmp_path, case, capsys):
    argv = [str(_band_dir(tmp_path)) if a == "BANDS" else a for a in PLAN_CASES[case]]
    common = ["--query_tsv_root", "/q", "--result_root", "/r"]
    ref_main(["make-plan", *argv, *common, "--out", str(tmp_path / "ref.json")])
    ref_out = capsys.readouterr().out
    port_main(["make-plan", *argv, *common, "--out", str(tmp_path / "port.json")])
    assert capsys.readouterr().out.replace("port.json", "ref.json") == ref_out
    want = (tmp_path / "ref.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    assert json.loads(want)["jobs"]


@pytest.mark.parametrize("argv,msg", [(["all-pairs"], "needs --index_root"), (["ablation"], "index_root_by_model")])
def test_make_plan_refusals_match(tmp_path, argv, msg):
    common = ["--query_tsv_root", "/q", "--result_root", "/r", "--out", str(tmp_path / "p.json")]
    with pytest.raises(SystemExit, match=msg):
        port_main(["make-plan", *argv, *common])
    with pytest.raises(SystemExit, match=msg):
        ref_main(["make-plan", *argv, *common])


def test_plan_builders_match():
    kw = dict(doc_langs=("en", "zh"), queries="/b", index_root="/ix", result_root="/r", qrels="/q", k_dense=400,
              query_cache_root="/c")
    assert port_plans.rerank_job(**kw) == ref_plans.rerank_job(**kw)
    kw = dict(kw, doc_langs=("zh",), checkpoint="/ck")
    assert port_plans.rerank_job(**kw) == ref_plans.rerank_job(**kw)
    kw = dict(doc_side="zh", lang_a="en", lang_b="zh", index_root="/ix", query_tsv_a="/a", query_tsv_b="/b",
              result_root="/r", qrels="/q", approx="guaranteed", query_cache_root="/c", alphas=(0.0, 0.5, 1.0))
    assert port_plans.vector_mix_job(**kw) == ref_plans.vector_mix_job(**kw)
    assert port_plans.mono_jobs_for_pairs() == ref_plans.mono_jobs_for_pairs()
    assert len(port_plans.build_all_pairs_plan(index_root="/i", query_tsv_root="/q", result_root="/r")["jobs"]) == 105


@pytest.mark.parametrize("tag,env", [("qwen3-embedding-8B", None), ("bge-m3", "96"), ("new-model", "x")])
def test_enc_batch_overrides_match(monkeypatch, tag, env):
    key = "ENC_BATCH_" + tag.upper().replace("-", "_").replace(".", "_")
    if env is not None:
        monkeypatch.setenv(key, env)
    assert port_plans.enc_batch_for(tag) == ref_plans.enc_batch_for(tag)


# --- storage -----------------------------------------------------------------

@pytest.mark.parametrize("min_free_gib", [0.0, 1e9])
def test_maybe_ephemeral_dir_matches(tmp_path, min_free_gib):
    got, got_eph = port_storage.maybe_ephemeral_dir(tmp_path / "p", min_free_gib, tmp_root=str(tmp_path))
    want, want_eph = ref_storage.maybe_ephemeral_dir(tmp_path / "r", min_free_gib, tmp_root=str(tmp_path))
    assert got_eph == want_eph == (min_free_gib > 0)
    assert got.is_dir() and (got == tmp_path / "p") == (not got_eph)


def test_ephemeral_run_dir_removed_on_success_kept_on_error(tmp_path):
    with port_storage.ephemeral_run_dir(tmp_path / "t", 1e9, tmp_root=str(tmp_path)) as d:
        assert d.is_dir()
    assert not d.exists()
    with pytest.raises(ValueError):
        with port_storage.ephemeral_run_dir(tmp_path / "t", 1e9, tmp_root=str(tmp_path)) as d:
            raise ValueError("job failed")
    assert d.exists()


# --- scheduler -----------------------------------------------------------------

def _fake_job(tmp_path, name, dur=0.5, jtype="", device=None, rc=0):
    out = tmp_path / "rec" / f"{name}.json"
    argv = [str(out), str(dur)] + ([str(rc)] if rc else [])
    return port_sched.Job(
        name=name, argv=argv, outdir=str(out.parent), expected=[out.name] if rc == 0 else [],
        env={"PYTHONPATH": str(REPO)}, jtype=jtype, device=device,
    )


def _run(jobs, **kw):
    return port_sched.Scheduler(jobs, module="tests.fake_job", poll_interval=0.05, **kw).run()


def _records(tmp_path):
    return {f.stem: json.loads(f.read_text()) for f in (tmp_path / "rec").glob("*.json")}


def _max_concurrent(intervals):
    events = sorted([(r["start"], 1) for r in intervals] + [(r["end"], -1) for r in intervals])
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return peak


def test_scheduler_device_slots_and_resume(tmp_path):
    jobs = [_fake_job(tmp_path, f"j{i}", dur=0.3) for i in range(5)]
    res = _run(jobs, device_slots={"a": 2, "b": 1})
    assert sorted(res.ran) == sorted(j.name for j in jobs) and not res.failed
    recs = _records(tmp_path)
    for dev, cap in (("a", 2), ("b", 1)):
        assert _max_concurrent([r for r in recs.values() if r["device"] == dev]) <= cap
    assert set(res.placements) == set(recs)
    # resume: every expected file exists, so nothing runs again
    res2 = _run(jobs, device_slots={"a": 2, "b": 1})
    assert sorted(res2.skipped) == sorted(j.name for j in jobs) and not res2.ran


def test_scheduler_pin_and_type_caps(tmp_path):
    jobs = [_fake_job(tmp_path, "pinned", dur=0.2, device="b")]
    jobs += [_fake_job(tmp_path, f"h{i}", dur=0.3, jtype="heavy") for i in range(3)]
    jobs += [_fake_job(tmp_path, f"l{i}", dur=0.3, jtype="light") for i in range(2)]
    res = _run(jobs, device_slots={"a": 4, "b": 1}, type_caps={"heavy": 1})
    assert not res.failed and res.placements["pinned"] == "b"
    recs = _records(tmp_path)
    assert _max_concurrent([r for n, r in recs.items() if n.startswith("h")]) <= 1
    assert _max_concurrent([r for n, r in recs.items() if n.startswith("l")]) == 2


def test_scheduler_unknown_pin_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown device"):
        port_sched.Scheduler([_fake_job(tmp_path, "x", device="nope")], device_slots={"a": 1})


def test_scheduler_fail_fast_kills_process_group(tmp_path):
    jobs = [_fake_job(tmp_path, "sleeper", dur=30.0), _fake_job(tmp_path, "bad", dur=0.1, rc=1)]
    t0 = time.monotonic()
    res = _run(jobs, device_slots={"a": 2}, max_failures=1)
    assert res.failed == ["bad"]
    assert time.monotonic() - t0 < 15  # the sleeper was killed, not awaited
    assert "sleeper" not in _records(tmp_path)


def test_scheduler_writes_job_logs(tmp_path):
    res = port_sched.Scheduler([_fake_job(tmp_path, "logged", dur=0.1)], module="tests.fake_job",
                               poll_interval=0.05, log_dir=tmp_path / "logs").run()
    assert res.ran == ["logged"] and (tmp_path / "logs" / "logged.log").exists()


def test_sweep_spawns_the_port_cli(tmp_path, monkeypatch):
    """The default module is the port's, for the job and for its evaluate
    steps, and the child is told its slot through ``CDR_DEVICE``."""
    spawned = []

    class Done:
        returncode = 0
        pid = 0

        def poll(self):
            return 0

    def fake_popen(cmd, **kw):
        spawned.append((cmd, kw["env"]["CDR_DEVICE"]))
        return Done()

    monkeypatch.setattr(port_sched.subprocess, "Popen", fake_popen)
    monkeypatch.setattr(port_sched.subprocess, "call", lambda cmd: spawned.append((cmd, None)) or 0)
    plan = {"jobs": [{"name": "j", "argv": ["run-mix", "--k", "5"], "outdir": str(tmp_path),
                      "eval_after": [["evaluate", "--run", "x"]]}]}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    assert port_sched.Scheduler(port_sched.load_plan(tmp_path / "plan.json")).module == "codemix_dense_retrieval_torch"
    port_main(["sweep", "--plan", str(tmp_path / "plan.json")])
    assert spawned == [
        ([sys.executable, "-m", "codemix_dense_retrieval_torch", "run-mix", "--k", "5"], "0"),
        ([sys.executable, "-m", "codemix_dense_retrieval_torch", "evaluate", "--run", "x"], None),
    ]


def test_plan_options_roundtrip(tmp_path):
    plan = {"jobs": [{"name": "j1", "argv": ["x"], "outdir": "runs/o", "type": "bilingual", "device": "a"}],
            "device_slots": {"a": 2, "b": 1}, "type_caps": {"bilingual": 1}}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    jobs = port_sched.load_plan(tmp_path / "plan.json")
    assert jobs[0].jtype == "bilingual" and jobs[0].device == "a"
    assert port_sched.load_plan_options(tmp_path / "plan.json") == ({"a": 2, "b": 1}, {"bilingual": 1})


# --- the CLI surface -------------------------------------------------------------

def _flags(parser, command):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.choices, a.required, a.type, type(a).__name__)
            for a in sub.choices[command]._actions if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("command", NEW_COMMANDS)
def test_new_subcommands_take_the_jax_flags(command):
    got, want = _flags(port_parser(), command), _flags(ref_parser(), command)
    if command == "analyze":
        assert got.pop("device") == (("--device",), "cuda", None, ("cuda", "cpu"), False, None, "_StoreAction")
        got.pop("dp"), want.pop("dp")  # the port's help text says one device; the flag is the same
    assert got == want


# --- one sweep end to end on the CPU --------------------------------------------------

def test_make_plan_sweep_collect_paper_values_end_to_end(tmp_path, capsys):
    from codemix_dense_retrieval_torch.index.flat import DenseFlatIndex
    from codemix_dense_retrieval_torch.io.tsv import write_queries_tsv
    from codemix_dense_retrieval_tpu.analysis.collect import collect_results as ref_collect

    rng = np.random.default_rng(12)
    docs = rng.standard_normal((200, 32)).astype(np.float32)
    ids = [f"d{i}" for i in range(200)]
    DenseFlatIndex.build(docs, ids).save(tmp_path / "ix" / "en")
    DenseFlatIndex.build(docs + 0.2 * rng.standard_normal(docs.shape).astype(np.float32), ids).save(
        tmp_path / "ix" / "zh")
    (tmp_path / "q").mkdir()
    write_queries_tsv(tmp_path / "q" / "queries.en.tsv", [(f"q{i}", f"english query {i}") for i in range(10)])
    write_queries_tsv(tmp_path / "q" / "queries.zh.tsv", [(f"q{i}", f"中文 查询 {i}") for i in range(10)])
    (tmp_path / "qrels.tsv").write_text("".join(f"q{i}\td{7 * i}\t1\n" for i in range(10)))
    port_main(["make-plan", "en-zh-repro", "--index_root", str(tmp_path / "ix"),
               "--query_tsv_root", str(tmp_path / "q"), "--result_root", str(tmp_path / "res"),
               "--qrels", str(tmp_path / "qrels.tsv"), "--size", "200", "--k", "10",
               "--runner_arg", "--device cpu --smoke_dim 32", "--out", str(tmp_path / "plan.json")])
    assert json.loads(capsys.readouterr().out)["jobs"] == 3
    port_main(["sweep", "--plan", str(tmp_path / "plan.json"), "--slots", "2"])
    swept = json.loads(capsys.readouterr().out)
    assert len(swept["ran"]) == 3 and not swept["failed"]
    for job in port_sched.load_plan(tmp_path / "plan.json"):
        assert job.complete(), job.name  # the runs and their -agg.json files
    port_main(["collect", "--results_root", str(tmp_path / "res"), "--out", str(tmp_path / "col.csv")])
    port_main(["collect", "--results_root", str(tmp_path / "res"), "--out", str(tmp_path / "ref.csv"),
               "--reference_format"])
    for name in ("col.csv", "ref.csv"):
        assert len((tmp_path / name).read_text().splitlines()) == 1 + 3 * 7
    rows = ref_collect(tmp_path / "res")
    assert sorted({r["doc_side"] for r in rows}) == ["bilingual-en-zh", "chinese", "english"]
    port_main(["paper-values", "--results_root", str(tmp_path / "res"), "--out", str(tmp_path / "pv.txt"),
               "--n_boot", "50"])
    assert len((tmp_path / "pv.txt").read_text().splitlines()) > 10
