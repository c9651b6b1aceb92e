"""The port's telemetry and fault modules (frl_distributed_ml_scaffold_
tpu_torch/telemetry/, faults/, utils/logging.py) against the JAX
package's: the same observations give byte-identical Prometheus text and
equal JSONL records, the same spans give the same Chrome-trace names,
categories and parents, and the retry policy, the fault sites and the
fault-plan parser agree."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import json
import re
import time

import pytest

from frl_distributed_ml_scaffold_tpu import faults as jfaults
from frl_distributed_ml_scaffold_tpu import telemetry as jtel
from frl_distributed_ml_scaffold_tpu.utils import logging as jlogging
from frl_distributed_ml_scaffold_tpu_torch import faults as tfaults
from frl_distributed_ml_scaffold_tpu_torch import telemetry as ttel
from frl_distributed_ml_scaffold_tpu_torch.utils import logging as tlogging


def _observe(tel):
    reg = tel.MetricsRegistry()
    c = reg.counter("train_steps_total", help="steps")
    c.inc(3)
    c.inc()
    g = reg.gauge("train_mfu", help="model FLOPs / chip peak")
    g.set(0.4125)
    reg.gauge("train_hbm_in_use_gib").set(12.0)
    h = reg.histogram("train_step_seconds", help="step time")
    for v in (1e-6, 3e-4, 0.0125, 0.5, 1.75, 100.0, 0.0125):
        h.observe(v)
    reg.histogram("train_data_wait_seconds", buckets=(0.001, 0.01, 0.1))
    off = tel.MetricsRegistry(enabled=False)
    off.counter("ignored").inc(5)
    return reg, off


def test_prometheus_text_and_jsonl_records_are_identical(monkeypatch,
                                                        tmp_path):
    jreg, joff = _observe(jtel)
    treg, toff = _observe(ttel)
    assert ttel.prometheus_text(treg) == jtel.prometheus_text(jreg)
    assert ttel.prometheus_text(toff) == jtel.prometheus_text(joff)
    monkeypatch.setattr(time, "time", lambda: 1234.5678)
    assert (ttel.jsonl_record(treg, step=7, extra={"phase": "x"})
            == jtel.jsonl_record(jreg, step=7, extra={"phase": "x"}))
    ttel.write_prometheus_file(treg, str(tmp_path / "t.prom"))
    jtel.write_prometheus_file(jreg, str(tmp_path / "j.prom"))
    assert (tmp_path / "t.prom").read_text() == (
        tmp_path / "j.prom").read_text()
    th = treg.histogram("train_step_seconds")
    jh = jreg.histogram("train_step_seconds")
    for q in (0.0, 0.5, 0.95, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    treg.reset()
    jreg.reset()
    assert ttel.prometheus_text(treg) == jtel.prometheus_text(jreg)


def _spans(tel):
    timeline = tel.Timeline()
    tracer = tel.Tracer(timeline=timeline)
    trace = tracer.new_trace("run")
    for step in range(2):
        with tracer.span("step", trace=trace, cat="train", step=step):
            with tracer.span("load_batch", cat="train", step=step):
                pass
            with tracer.span("dispatch", cat="train", step=step,
                             step_num=step):
                pass
    root = tracer.begin("request", trace=tracer.new_trace(), cat="serve")
    tracer.emit("queue", t0=root.t0, dur_s=0.5, parent=root, cat="serve")
    root.end(tokens=3)
    off = tel.Tracer(enabled=False)
    with off.span("nothing"):
        pass
    return tracer, timeline, off


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def test_tracer_spans_export_the_same_chrome_trace():
    jtr, jtl, joff = _spans(jtel)
    ttr, ttl, toff = _spans(ttel)
    jev, tev = jtr.chrome_trace()["traceEvents"], ttr.chrome_trace()[
        "traceEvents"]
    assert _strip(tev) == _strip(jev)
    assert [e.get("args", {}).get("parent") for e in tev] == [
        e.get("args", {}).get("parent") for e in jev]
    strip = lambda recs: [{k: v for k, v in r.items()  # noqa: E731
                           if k not in ("ts", "dur_s")} for r in recs]
    assert strip(ttl.drain()) == strip(jtl.drain())
    assert len(toff) == len(joff) == 0
    annotated = ttel.Tracer(annotate=True)
    with annotated.span("dispatch", step_num=3):
        pass
    assert [s["name"] for s in annotated.spans()] == ["dispatch"]


@pytest.mark.parametrize("kw", [
    dict(), dict(max_retries=5, backoff_s=0.05, max_backoff_s=0.3),
    dict(max_retries=4, backoff_s=1.0, jitter=0.25, seed=7),
    dict(max_retries=0, backoff_s=2.0)])
def test_retry_policy_delays_are_equal(kw):
    assert list(tfaults.RetryPolicy(**kw).delays()) == list(
        jfaults.RetryPolicy(**kw).delays())


def test_retry_policy_call_counts_and_propagates_alike():
    def run(faults_mod):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return len(calls)

        seen = []
        out = faults_mod.RetryPolicy(max_retries=2, backoff_s=0.0).call(
            flaky, on_retry=lambda a, e: seen.append(a))
        with pytest.raises(OSError, match="always"):
            faults_mod.RetryPolicy(max_retries=1, backoff_s=0.0).call(
                lambda: (_ for _ in ()).throw(OSError("always")))
        return out, seen

    assert run(tfaults) == run(jfaults) == (3, [1, 2])


def test_known_sites_are_equal():
    assert tfaults.KNOWN_SITES == jfaults.KNOWN_SITES


SPECS = [
    '[{"site": "data.loader", "key": "2"}]',
    '{"seed": 3, "specs": [{"site": "trainer.preempt", "at": 2, "times": 0,'
    ' "p": 0.5}]}',
    '[{"site": "checkpoint.torn_write"}, {"site": "trainer.hung_step",'
    ' "arg": 0.25}]',
    '[]',
    'not json',
    '{"specs": {"site": "data.loader"}}',
    '[{"site": "data.loadr"}]',
    '[{"site": "data.loader", "at": 0}]',
    '[{"site": "data.loader", "times": -1}]',
    '[{"site": "data.loader", "p": 1.5}]',
    '[{"site": "data.loader", "bogus": 1}]',
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_from_env_accepts_and_refuses_alike(spec):
    def parse(faults_mod):
        try:
            plan = faults_mod.FaultPlan.from_env(spec)
        except (ValueError, TypeError) as e:
            return type(e).__name__, str(e)
        fired = [(site, key, plan.fire(site, key) is not None)
                 for site in sorted(faults_mod.KNOWN_SITES)
                 for key in ("", "2", "3") for _ in range(3)]
        return plan.sites, plan.seed, fired, plan.injected

    assert parse(tfaults) == parse(jfaults)


def test_fault_plan_counts_injections_in_the_registry():
    def run(faults_mod, tel):
        reg = tel.MetricsRegistry()
        plan = faults_mod.FaultPlan([dict(site="data.loader", at=2,
                                          times=2)], registry=reg)
        with faults_mod.active(plan):
            fired = [faults_mod.fire("data.loader") is not None
                     for _ in range(5)]
            with pytest.raises(RuntimeError, match="injected fault"):
                faults_mod.install(faults_mod.FaultPlan(
                    [dict(site="data.loader")]))
                faults_mod.maybe_raise("data.loader", key=4)
        faults_mod.install(None)
        return fired, tel.prometheus_text(reg)

    assert run(tfaults, ttel) == run(jfaults, jtel)


def test_stall_watchdog_fires_once_per_silence(tmp_path):
    reg = ttel.MetricsRegistry()
    timeline = ttel.Timeline()
    timeline.event("dispatch", dur_s=0.1, step=0)
    dump = tmp_path / "stall_dump.txt"
    with ttel.StallWatchdog(0.05, registry=reg, timeline=timeline,
                            dump_path=str(dump), poll_s=0.01,
                            first_beat_scale=1.0) as wd:
        wd.beat()
        deadline = time.monotonic() + 5
        while wd.fired < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        assert wd.fired == 1
    assert "no progress" in dump.read_text()
    assert "stalls_total 1" in ttel.prometheus_text(reg)


def test_jsonl_writer_repairs_a_torn_line_alike(tmp_path):
    for mod, name in ((tlogging, "t.jsonl"), (jlogging, "j.jsonl")):
        path = tmp_path / name
        path.write_text('{"step": 1}\n{"step": 2}\n{"ste')
        w = mod.JsonlWriter(str(path))
        w.write({"step": 3, "loss": 0.5})
        w.close()
    assert (tmp_path / "t.jsonl").read_text() == (
        tmp_path / "j.jsonl").read_text()
    assert [json.loads(x)["step"] for x in
            (tmp_path / "t.jsonl").read_text().splitlines()] == [1, 2, 3]


def _fit(tmp_path, *extra):
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    cfg = apply_overrides(get_config("mnist_mlp"), [
        "model.hidden_sizes=16", "data.global_batch_size=8",
        "trainer.total_steps=6", "trainer.log_every=2",
        "trainer.eval_every=0", f"workdir={tmp_path}", *extra])
    trainer = Trainer(cfg, device="cpu")
    state, last = trainer.fit()
    return trainer, state, tmp_path / "mnist_mlp"


def test_hung_step_fires_the_loop_watchdog(tmp_path):
    """A hung step (1.5 s against a 0.3 s deadline) is reported: the
    stalls counter in metrics.prom and the dump, and the run completes.
    An ordinary step on a loaded host may also pass the deadline, so the
    count is held to at least one, as the JAX twin holds it."""
    with tfaults.active(tfaults.FaultPlan(
            [dict(site="trainer.hung_step", key="3", arg=1.5)])):
        _, state, run = _fit(tmp_path, "trainer.stall_timeout_s=0.3",
                             "trainer.stall_timeout_first_beat_scale=200")
    assert state.step == 6
    stalls = re.search(r"^stalls_total (\S+)$",
                       (run / "metrics.prom").read_text(), re.M)
    assert stalls is not None and float(stalls[1]) >= 1
    assert "no progress" in (run / "stall_dump.txt").read_text()


def test_loader_fault_is_retried_inside_fit(tmp_path):
    with tfaults.active(tfaults.FaultPlan([dict(site="data.loader",
                                                key="2")])):
        trainer, state, _ = _fit(tmp_path, "data.loader_retry_backoff_s=0")
    assert state.step == 6 and trainer.pipeline.loader_retries == 1


def test_profiler_window_and_tracing_off(tmp_path):
    """``trainer.profile_steps`` writes a torch.profiler Chrome trace;
    ``trainer.tracing=false`` writes no span file but telemetry.jsonl
    keeps the phase records."""
    _, _, run = _fit(tmp_path, "trainer.profile_start_step=1",
                     "trainer.profile_steps=2", "trainer.tracing=false")
    trace = json.loads((run / "trace" / "trace.json").read_text())
    assert any("train step" in e.get("name", "")
               for e in trace["traceEvents"])
    assert not (run / "trace_events.json").exists()
    recs = [json.loads(x) for x in
            (run / "telemetry.jsonl").read_text().splitlines()]
    names = {r.get("name") for r in recs if r["event"] == "timeline"}
    assert names == {"load_batch", "dispatch"}
    snap = [r for r in recs if r["event"] == "telemetry"][-1]
    assert snap["metrics"]["train_steps_total"] == 6
