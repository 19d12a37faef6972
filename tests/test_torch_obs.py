"""The port's flight recorder, metrics registry and perf history
(``repro_torch.obs``), alone and against the JAX package's
(``repro.obs``).

1. Spans: disarmed ``span()`` is one shared no-op; armed spans nest per
   thread, stream to JSONL and reload; the summary's phase totals and
   per-round sums; re-arming closes the previous recorder; the
   ``torch.profiler`` passthrough writes a Chrome trace holding the spans,
   the fusion worker's too.
2. Registry: instruments, a type mismatch raises, ``TraceCounter`` is the
   registry's ``Counter``, ``MetricsObserver`` emits counter deltas.
3. ``ObsSpec`` round-trips between the packages and now validates in the
   port; a profile needs its directory.
4. An armed run equals a disarmed one bit for bit (``sync``,
   ``buffered_async``, ``async_pipelined``), streams its metrics and
   spans, and sets ``RunResult.obs``.
5. Against JAX: a run's set of (span name, depth, parent) equals the JAX
   run's on the same spec; on a chaos spec the registry's fault counters
   and teacher forwards equal JAX's; history records validate across the
   packages.
"""
import json
import os
import threading

import pytest

from repro import api as japi
from repro.obs import history as jhistory
from repro.obs import trace as jtrace
from repro.obs.metrics import REGISTRY as JREGISTRY
from repro_torch import api as tapi
from repro_torch.common.counters import TraceCounter
from repro_torch.common.pytree import tree_flatten
from repro_torch.obs import history, trace
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MemorySink, MetricsObserver,
                                     MetricsRegistry)


def toy_spec(pkg, strategy="feddf", rounds=2, driver=None, obs=None):
    return pkg.ExperimentSpec(
        task=pkg.TaskSpec(name="blobs", n_samples=600),
        partition=pkg.PartitionSpec(n_clients=6, alpha=1.0),
        cohort=pkg.CohortSpec(prototypes=[pkg.ModelSpec(
            "mlp", {"hidden": [16, 16]})]),
        strategy=pkg.StrategySpec(name=strategy, fusion=pkg.FusionSpec(
            max_steps=40, patience=40, eval_every=20, batch_size=32)),
        source=(pkg.SourceSpec(name="unlabeled", params={"n": 300})
                if strategy == "feddf" else None),
        driver=driver or pkg.DriverSpec(), obs=obs or pkg.ObsSpec(),
        rounds=rounds, client_fraction=0.5, local_epochs=2,
        local_batch_size=32, local_lr=0.05, seed=0)


@pytest.fixture(autouse=True)
def _clean_recorders():
    trace.disarm()
    jtrace.disarm()
    yield
    trace.disarm()
    jtrace.disarm()


def same_globals(a, b) -> bool:
    fa, fb = tree_flatten(a), tree_flatten(b)
    return list(fa) == list(fb) and all(bool((fa[k] == fb[k]).all())
                                        for k in fa)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_disarmed_span_is_shared_noop():
    s1, s2 = trace.span("anything", round=3), trace.span("else")
    assert s1 is s2
    with s1 as sp:
        sp.annotate(k=1)
    trace.set_context(driver="x")  # no-op, no error
    assert trace.recorder() is None


def test_armed_spans_nest_per_thread_and_reload(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    trace.arm(path=path)
    trace.set_context(driver="sync")
    with trace.span("outer", round=0):
        with trace.span("inner", round=0):
            # another thread's span opens at depth 0, not under "outer"
            th = threading.Thread(target=lambda: trace.span(
                "worker", round=0).__enter__().__exit__(None, None, None))
            th.start()
            th.join(10)
            assert not th.is_alive()
    with trace.span("outer", round=1) as sp:
        sp.annotate(quarantined=2)
    trace.disarm()
    spans = trace.load_spans(path)
    assert [s["name"] for s in spans] == ["worker", "inner", "outer",
                                          "outer"]
    worker, inner, outer0, outer1 = spans
    assert (worker["depth"], worker["parent"]) == (0, None)
    assert worker["thread"] != inner["thread"]
    assert (inner["depth"], inner["parent"]) == (1, "outer")
    assert (outer0["depth"], outer0["parent"]) == (0, None)
    assert outer1["quarantined"] == 2
    for s in spans:
        assert s["t1"] >= s["t0"] >= 0.0
        assert s["dur_s"] == pytest.approx(s["t1"] - s["t0"])
        assert s["driver"] == "sync"
    assert outer0["t0"] <= inner["t0"] and inner["t1"] <= outer0["t1"]


def test_summary_totals_and_per_round_sums():
    rec = trace.arm()
    for t in range(2):
        for _ in range(2):
            with trace.span("train_clients", round=t):
                pass
        with trace.span("join_fusion", round=t):
            pass
    with trace.span("sample_cohort"):
        pass
    s = rec.summary()
    assert s["n_spans"] == 7
    totals = s["phase_totals_s"]
    assert set(totals) == {"train_clients", "join_fusion", "sample_cohort"}
    assert s["idle_gap_s"] == pytest.approx(totals["join_fusion"])
    assert set(s["per_round"]) == {"0", "1"}
    for name in ("train_clients", "join_fusion"):
        assert sum(r[name] for r in s["per_round"].values()) == \
            pytest.approx(totals[name])
        assert totals[name] == pytest.approx(sum(
            x["dur_s"] for x in rec.spans if x["name"] == name))


def test_rearm_closes_previous_recorder(tmp_path):
    trace.arm(path=str(tmp_path / "a.jsonl"))
    first = trace.recorder()
    trace.arm(path=str(tmp_path / "b.jsonl"))
    assert trace.recorder() is not first and first._f is None
    with trace.span("x"):
        pass
    trace.disarm()
    assert trace.load_spans(str(tmp_path / "a.jsonl")) == []
    assert len(trace.load_spans(str(tmp_path / "b.jsonl"))) == 1


def test_profiler_passthrough_writes_the_spans(tmp_path):
    """Armed with ``profile_dir``, the run's spans are ``record_function``
    ranges of a Chrome trace, the pipelined driver's fusion worker's
    too."""
    d = str(tmp_path / "prof")
    spec = toy_spec(tapi, rounds=2,
                    driver=tapi.DriverSpec(kind="async_pipelined",
                                           staleness=1),
                    obs=tapi.ObsSpec(profile=True, profile_dir=d))
    res = tapi.Experiment(spec, device="cpu").run()
    assert trace.recorder() is None and res.obs["n_spans"] > 0
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events
             if e.get("cat") == "user_annotation"}
    assert {"train_clients", "join_fusion", "evaluate_round",
            "aggregate", "bank_build"} <= names


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_instruments_and_snapshot():
    reg = MetricsRegistry()
    c = reg.counter("a.count")
    assert reg.counter("a.count") is c
    c.add(2)
    c.add()
    g = reg.gauge("a.gauge")
    assert g.value() is None
    g.set(7)
    h = reg.histogram("a.hist")
    for v in (1.0, 3.0):
        h.observe(v)
    assert reg.snapshot() == {
        "a.count": 3, "a.gauge": 7,
        "a.hist": {"count": 2, "total": 4.0, "mean": 2.0, "min": 1.0,
                   "max": 3.0}}
    reg.reset()
    assert reg.snapshot() == {"a.count": 0}
    for cls, name in ((Counter, "counter"), (Gauge, "gauge"),
                      (Histogram, "histogram")):
        assert isinstance(getattr(reg, name)(f"x.{name}"), cls)


def test_registry_type_mismatch_raises():
    reg = MetricsRegistry()
    reg.counter("dup")
    with pytest.raises(TypeError, match="already registered as Counter"):
        reg.gauge("dup")


def test_trace_counter_is_the_registry_counter():
    from repro_torch.core import logit_bank
    assert TraceCounter is Counter
    tf = REGISTRY.counter("core.logit_bank.teacher_forwards")
    assert logit_bank.TEACHER_FORWARDS is tf
    tf.reset()
    logit_bank.TEACHER_FORWARDS.add(5)
    assert REGISTRY.snapshot()["core.logit_bank.teacher_forwards"] == 5
    assert "core.client.compiles" not in REGISTRY.snapshot()


class _Event:
    def __init__(self, round, test_acc, val_acc):
        self.round, self.group = round, 0
        self.log = type("L", (), {"test_acc": test_acc,
                                  "val_acc": val_acc})()


def test_metrics_observer_emits_counter_deltas():
    reg = MetricsRegistry()
    c = reg.counter("work")
    reg.gauge("level").set(2.5)
    sink = MemorySink()
    obs = MetricsObserver([sink], registry=reg)
    c.add(4)
    obs(_Event(1, 0.5, 0.4))
    c.add(1)
    obs(_Event(2, 0.6, 0.5))
    assert [r["work"] for r in sink.records] == [4, 1]
    assert [r["level"] for r in sink.records] == [2.5, 2.5]
    assert [r["round"] for r in sink.records] == [1, 2]
    assert "device_peak_bytes" not in sink.records[0]  # a CPU process


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------

def test_obs_spec_round_trips_and_validates():
    obs = {"trace": True, "trace_path": "t.jsonl", "metrics_dir": "m",
           "profile": True, "profile_dir": "p"}
    jspec = toy_spec(japi, obs=japi.ObsSpec(**obs))
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    assert tspec.obs == tapi.ObsSpec(**obs) and tspec.obs.enabled
    assert tspec.to_json() == jspec.to_json()
    assert tspec.validate() is tspec
    bad = toy_spec(tapi, obs=tapi.ObsSpec(profile=True))
    with pytest.raises(ValueError, match="profile_dir"):
        bad.validate()
    with pytest.raises(ValueError, match="unknown field"):
        tapi.ObsSpec.from_dict({"trace": True, "sample_rate": 2})


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver,staleness", [("sync", 0),
                                              ("buffered_async", 0),
                                              ("async_pipelined", 1)])
def test_armed_run_equals_disarmed_bit_for_bit(tmp_path, driver, staleness):
    drv = tapi.DriverSpec(kind=driver, staleness=staleness)
    plain = tapi.Experiment(toy_spec(tapi, driver=drv), device="cpu").run()
    obs = tapi.ObsSpec(trace=True, trace_path=str(tmp_path / "s.jsonl"),
                       metrics_dir=str(tmp_path / "m"))
    armed = tapi.Experiment(toy_spec(tapi, driver=drv, obs=obs),
                            device="cpu").run()
    assert armed.result.logs == plain.result.logs
    assert same_globals(armed.global_params[0], plain.global_params[0])
    assert plain.obs is None and "obs" not in plain.summary()
    assert armed.summary()["obs"]["n_spans"] > 0
    assert trace.recorder() is None
    phases = set(armed.obs["phase_totals_s"])
    assert {"build_round_batches", "train_clients", "aggregate",
            "evaluate_round", "bank_build"} <= phases
    assert ({"fill", "wave", "join_fusion"} if driver == "buffered_async"
            else {"sample_cohort"}) <= phases
    spans = trace.load_spans(str(tmp_path / "s.jsonl"))
    assert {s["driver"] for s in spans} == {driver}
    with open(tmp_path / "m" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["round"] for r in lines] == [1, 2]
    assert all("core.logit_bank.teacher_forwards" in r for r in lines)
    assert os.path.exists(tmp_path / "m" / "metrics.csv")


def _span_shape(path):
    return {(s["name"], s["depth"], s["parent"])
            for s in trace.load_spans(path)}


def test_span_taxonomy_matches_jax(tmp_path):
    """The same spec, checkpointed, through both packages: every (span
    name, depth, parent) the JAX run records, the port's records, and no
    other."""
    runs = {}
    for name, pkg, kw in (("jax", japi, {}), ("port", tapi,
                                              {"device": "cpu"})):
        path = str(tmp_path / f"{name}.jsonl")
        spec = toy_spec(pkg, obs=pkg.ObsSpec(trace_path=path))
        pkg.Experiment(spec, **kw).run(
            checkpoint_dir=str(tmp_path / f"ck_{name}"))
        runs[name] = _span_shape(path)
    assert runs["port"] == runs["jax"]
    assert ("bank_build", 1, "aggregate") in runs["port"]
    assert ("checkpoint_write", 0, None) in runs["port"]


def test_chaos_registry_counters_match_jax():
    from test_torch_robust import CHAOS, chaos_spec, facts, run_both
    names = ("core.faults.corrupted", "core.faults.quarantined",
             "core.faults.retries", "core.logit_bank.teacher_forwards")
    JREGISTRY.reset()
    REGISTRY.reset()
    jres, tres = run_both(chaos_spec(japi, faults=CHAOS))
    assert facts(tres) == facts(jres)
    jsnap, tsnap = JREGISTRY.snapshot(), REGISTRY.snapshot()
    assert {k: tsnap[k] for k in names} == {k: jsnap[k] for k in names}
    assert tsnap["core.faults.corrupted"] == sum(
        l.n_corrupted for l in tres.result.logs) > 0
    assert tsnap["core.logit_bank.teacher_forwards"] == sum(
        l.teacher_forwards for l in tres.result.logs)


# ---------------------------------------------------------------------------
# perf history
# ---------------------------------------------------------------------------

def test_history_records_validate_across_packages(tmp_path):
    rec = history.make_record("driver", {"round_s": 1.5},
                              config={"rounds": 3}, case="cpu")
    jhistory.validate_record(rec)
    assert rec["machine"]["backend"] == "cpu" and "torch" in rec["machine"]
    jrec = jhistory.make_record("driver", {"round_s": 2.0})
    history.validate_record(jrec)
    path = str(tmp_path / "h.jsonl")
    history.append(rec, path)
    jhistory.append(jrec, path)
    assert len(jhistory.load(path)) == len(history.load(path)) == 2
    assert set(history.latest(path)) == {("driver", "cpu"),
                                         ("driver", "default")}
    for bad in ({**rec, "schema_version": 2}, {**rec, "extra": 1},
                {k: v for k, v in rec.items() if k != "metrics"}):
        with pytest.raises(ValueError):
            history.validate_record(bad)
        with pytest.raises(ValueError):
            jhistory.validate_record(bad)
    with open(path, "a") as f:
        f.write("not json\n")
    with pytest.raises(ValueError, match="not JSON"):
        history.load(path)
    assert history.load(str(tmp_path / "absent.jsonl")) == []
