"""The port's observability and serving building blocks against the JAX
package's: the same scripted inputs into each module and its port, the same
outputs, exactly.

- ``utils/faults.py``: spec parsing (and its errors), which hits fire;
- ``observability/tracer.py``: Chrome-trace and JSONL export minus
  timestamps, sampling decisions, traceparent round trips;
- ``observability/flight_recorder.py``: records and reason validation;
- ``serving/metrics.py``: the exposition text of one scripted registry;
- ``serving/brownout.py``: the level sequence under an injected clock;
- ``serving/chat.py``: ``ChatTemplate`` renders and their errors;
- ``observability/usage.py`` + ``serving/tenancy/metering.py``: usage records,
  the sealed ledger files and the metering totals;
- ``observability/exporter.py``: the profile capture's one-at-a-time guard,
  and the port's ``torch.profiler`` capture, started and stopped on another
  thread, recording that thread's ops.
"""

import json
import os
import queue
import threading
import time
import types

import pytest
import torch

from paddlenlp_tpu.observability import flight_recorder as j_recorder
from paddlenlp_tpu.observability import tracer as j_tracer
from paddlenlp_tpu.observability import usage as j_usage
from paddlenlp_tpu.observability.exporter import ProfileCapture as JProfileCapture
from paddlenlp_tpu.observability.exporter import handle_profile_request as j_handle_profile
from paddlenlp_tpu.serving import brownout as j_brownout
from paddlenlp_tpu.serving import chat as j_chat
from paddlenlp_tpu.serving import metrics as j_metrics
from paddlenlp_tpu.serving.tenancy import metering as j_metering
from paddlenlp_tpu.utils import faults as j_faults
from paddlenlp_tpu_torch.observability import exporter as p_exporter
from paddlenlp_tpu_torch.observability import flight_recorder as p_recorder
from paddlenlp_tpu_torch.observability import tracer as p_tracer
from paddlenlp_tpu_torch.observability import usage as p_usage
from paddlenlp_tpu_torch.serving import brownout as p_brownout
from paddlenlp_tpu_torch.serving import chat as p_chat
from paddlenlp_tpu_torch.serving import metrics as p_metrics
from paddlenlp_tpu_torch.serving.tenancy import metering as p_metering
from paddlenlp_tpu_torch.utils import faults as p_faults

def both(fn):
    """``fn(module set)`` for the JAX modules and the port's: (jax, port)."""
    j = types.SimpleNamespace(faults=j_faults, tracer=j_tracer, recorder=j_recorder, metrics=j_metrics,
                              brownout=j_brownout, chat=j_chat, usage=j_usage, metering=j_metering)
    p = types.SimpleNamespace(faults=p_faults, tracer=p_tracer, recorder=p_recorder, metrics=p_metrics,
                              brownout=p_brownout, chat=p_chat, usage=p_usage, metering=p_metering)
    return fn(j), fn(p)


def outcome(fn):
    """The value, or the exception's type name and message."""
    try:
        return ("ok", fn())
    except Exception as e:  # the error itself is what is compared
        return ("error", type(e).__name__, str(e))


# ----------------------------------------------------------------------------- faults
SPECS = [
    "engine.step:nth=3",
    "engine.step:nth=2,5:times=2",
    "ckpt.write_shard:p=0.3:seed=7:times=4",
    "engine.step:p=0.5:seed=11:times=0",
    "engine.rebuild:action=delay:delay_s=0:nth=1",
    "engine.step:nth=1;engine.prefill_chunk:nth=2",
    "tpyo.step:nth=1",
    "engine.step:nth=x",
    "engine.step:action=explode",
    "engine.step",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parsing_and_firing(spec):
    def run(m):
        reg = m.faults.FaultRegistry()
        armed = outcome(lambda: reg.arm_from_spec(spec))
        if armed[0] == "error":
            return armed
        fired = []
        for hit in range(1, 21):
            for name in ("engine.step", "ckpt.write_shard", "engine.rebuild", "engine.prefill_chunk"):
                try:
                    reg.fire(name)
                except m.faults.InjectedFault as e:
                    fired.append((name, hit, str(e)))
        return fired, {n: (reg.hits(n), reg.fired(n)) for n in ("engine.step", "ckpt.write_shard")}

    j, p = both(run)
    assert p == j


def test_fault_point_names_and_catalog():
    j, p = both(lambda m: (sorted(m.faults.CATALOG), outcome(lambda: m.faults.FaultPoint("no.such_point"))))
    assert p == j and p[1][0] == "error"


# ----------------------------------------------------------------------------- tracer
def _trace_script(m):
    tr = m.tracer.SpanTracer(capacity=4, sample_every=4)
    with tr.span("prefill", cat="engine", batch=2, trace="req-0"):
        pass
    tr.instant("kv_alloc", cat="engine", trace="req-1", tokens=5)
    tr.mark_trace("req-2", False)
    tr.instant("kv_free", cat="engine", trace="req-2")
    with m.tracer.use_trace("req-3"):
        tr.instant("preempt", cat="engine", generated=3)
    for i in range(8):
        tr.add_span("queue", tr.now(), 0.001 * i, cat="request", trace=f"req-{10 + i}", wall=False, i=i)
    tr.add_span("engine_degraded", time.time(), 0.5, cat="engine_loop", wall=True, error="x")
    doc = tr.chrome_trace()
    for ev in doc["traceEvents"]:
        ev.pop("ts", None)
        ev.pop("dur", None)
        ev.pop("tid", None)
        if ev.get("ph") == "M":
            ev["args"] = None
    lines = [json.loads(line) for line in tr.to_jsonl().splitlines()]
    for d in lines:
        for k in ("ts", "dur", "tid", "thread"):
            d.pop(k, None)
    small = m.tracer.SpanTracer(capacity=2)
    for i in range(5):
        small.instant("kv_alloc", i=i)
    header = m.tracer.format_traceparent("rtr-7", "route-3", sampled=False)
    return (doc, lines, (tr.dropped, small.dropped, [s.args for s in small.snapshot()]), header,
            m.tracer.parse_traceparent(header), m.tracer.parse_traceparent("garbage"),
            [m.tracer.trace_sampled(f"rtr-{i}", 8) for i in range(32)])


def test_tracer_export_minus_timestamps():
    j, p = both(_trace_script)
    assert p == j
    assert p[2][1] == 3  # the 2-span ring overflowed


def test_merge_chrome_traces_matches():
    def run(m):
        a, b = m.tracer.SpanTracer(), m.tracer.SpanTracer()
        a.instant("route", trace="rtr-0")
        b.instant("prefill", trace="rtr-0")
        merged = m.tracer.merge_chrome_traces([a.chrome_trace(), b.chrome_trace()])
        return sorted((e["name"], e["pid"], e["ph"]) for e in merged["traceEvents"])

    j, p = both(run)
    assert p == j


# ----------------------------------------------------------------------------- flight recorder
def test_flight_recorder_records_match():
    def run(m):
        rec = m.recorder.FlightRecorder(capacity=4, enabled=True)
        rec.record("admit.accept", req_id=1, trace="req-1", slot=0, prompt_len=5, cached_tokens=4)
        rec.record("admit.defer", req_id=2, trace="req-2", reason="kv_pressure", queue_depth=3)
        rec.record("preempt", req_id=1, trace="req-1", reason="decode_growth", generated=7)
        rec.record("chunk.grant", req_id=3, tokens=8, budget_left=0)
        rec.record("swap.begin", version="v1", mode="finish_old")
        errors = [outcome(lambda: rec.record("admit.defer", reason="no_such_reason")),
                  outcome(lambda: rec.record("no.such.event"))]
        dicts = rec.to_dicts(rec.snapshot())
        for d in dicts:
            d.pop("t")
        return dicts, len(rec), [e["name"] for e in rec.to_dicts(rec.snapshot(trace="req-1"))], errors

    j, p = both(run)
    assert p == j
    assert p[1] == 4 and p[3][0][0] == "error" and p[3][1][0] == "error"


# ----------------------------------------------------------------------------- metrics registry
def test_metrics_exposition_text_matches():
    def run(m):
        reg = m.metrics.MetricsRegistry()
        c = reg.counter("demo_requests_total", "Finished requests", labelnames=("status", "tenant"))
        c.inc(status="length", tenant="a")
        c.inc(3, status="stop", tenant="b")
        g = reg.gauge("demo_queue_depth", "Waiting requests")
        g.set(4)
        f = reg.gauge("demo_pulled", "Pulled at scrape")
        f.set_function(lambda: 2.5)
        h = reg.histogram("demo_latency_seconds", "Latency", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        lh = reg.histogram("demo_phase_seconds", "Phases", labelnames=("phase",), buckets=(0.1, 1.0))
        lh.observe(0.2, phase="queue")
        w = reg.gauge("demo_info", "Info", labelnames=("version",))
        w.set(1.0, version="v0")
        w.remove_series(version="v0")
        w.set(1.0, version="v1")
        bad = [outcome(lambda: c.inc(-1, status="x", tenant="y")),
               outcome(lambda: reg.gauge("demo_requests_total", "clash"))]
        return reg.expose(), c.value(status="stop", tenant="b"), bad

    j, p = both(run)
    assert p == j
    assert "demo_latency_seconds_bucket" in p[0]


# ----------------------------------------------------------------------------- brownout
def test_brownout_level_sequence_under_injected_clock():
    pressures = [0.2, 1.2, 1.2, 1.5, 2.0, 2.0, 0.7, 0.3, 0.3, 0.3, 0.2, 0.2, 0.1, 0.1, 0.1]

    def run(m):
        readings = iter(pressures)
        changes = []
        ctl = m.brownout.BrownoutController(
            m.brownout.BrownoutPolicy(step_hold_s=1.0, exit_hold_s=2.0), pressure_fn=lambda: next(readings),
            on_level_change=changes.append)
        levels = []
        for i in range(len(pressures)):
            now = 1000.0 + 1.5 * i
            levels.append((ctl.evaluate(now=now), ctl.should_shed("best_effort", now=now),
                           ctl.max_tokens_cap(now=now), ctl.spec_disabled(now=now)))
        pushed = ctl.push(3, reason="slo_fast_burn", ttl_s=5.0, now=1030.0)
        expired = ctl.push(0, now=1040.0)
        stats = ctl.stats()
        return levels, changes, pushed, expired, {k: v for k, v in stats.items() if "_t" not in k}

    j, p = both(run)
    assert p == j
    assert max(lv for lv, *_ in p[0]) == 3 and p[0][-1][0] < 3


# ----------------------------------------------------------------------------- chat
CHATS = [
    [{"role": "user", "content": [10, 11]}],
    [{"role": "system", "content": [7]}, {"role": "user", "content": [10, 11]},
     {"role": "assistant", "content": [20, 21, 22]}, {"role": "user", "content": "hi"}],
    [],
    [{"role": "user", "content": [10]}, {"role": "system", "content": [7]}, {"role": "user", "content": [1]}],
    [{"role": "user", "content": [10]}, {"role": "assistant", "content": [11]}],
    [{"role": "robot", "content": [10]}],
    [{"role": "user", "content": []}],
    [{"role": "user", "content": 5}],
]


@pytest.mark.parametrize("messages", CHATS, ids=range(len(CHATS)))
def test_chat_template_renders(messages):
    encode = lambda text: [ord(c) % 90 + 5 for c in text]  # noqa: E731
    j, p = both(lambda m: outcome(lambda: m.chat.ChatTemplate().render(messages, encode)))
    assert p == j


# ----------------------------------------------------------------------------- usage metering
def _finished(req_id, tenant, prompt, out, cached, useful, reason="length", trace=None):
    return types.SimpleNamespace(
        req_id=req_id, prompt_ids=list(range(prompt)), base_prompt_len=prompt, output_ids=list(range(out)),
        trace=trace or f"req-{req_id}", tenant=tenant, adapter_id=None, priority="interactive",
        finish_reason=reason, aborted=reason == "abort", arrival_t=100.0 + req_id, finish_t=101.5 + req_id,
        cached_tokens=cached, useful_tokens=useful, kv_block_seconds=0.25 * req_id)


def test_usage_records_ledger_and_metering_totals(tmp_path):
    reqs = [_finished(0, "default", 12, 9, 0, 21), _finished(1, "a", 7, 6, 4, 9),
            _finished(2, "a", 4, 5, 0, 8, reason="abort"), _finished(3, "b", 20, 1, 16, 5, reason="stop")]

    def run(m):
        d = tmp_path / m.__name__
        reg = m.metrics.MetricsRegistry()
        metrics = types.SimpleNamespace(
            usage_tokens=reg.counter("paddlenlp_serving_usage_tokens_total", "t",
                                     labelnames=("tenant", "adapter", "kind")),
            usage_records=reg.counter("paddlenlp_serving_usage_records_total", "r", labelnames=("tenant",)))
        meter = m.metering.UsageMeter(ledger=m.usage.UsageLedger(str(d), replica="r0", max_segment_records=2),
                                      metrics=metrics)
        records = [meter.record_finished(r, attribution={"queue": 0.1, "decode": 0.5}) for r in reqs]
        dup = meter.record_finished(reqs[1])
        snap = meter.snapshot()
        meter.close()
        loaded, stats = m.usage.load_ledger_dir(str(d))
        strip = lambda rs: [{k: v for k, v in r.items() if k not in ("booked_t", "replica")} for r in rs]  # noqa: E731
        return strip(records), dup, snap["totals"], snap.get("by_tenant"), strip(loaded), \
            sorted(os.listdir(d)), reg.expose()

    j_mod = types.SimpleNamespace(__name__="jax", metrics=j_metrics, metering=j_metering, usage=j_usage)
    p_mod = types.SimpleNamespace(__name__="port", metrics=p_metrics, metering=p_metering, usage=p_usage)
    j, p = run(j_mod), run(p_mod)
    assert p == j
    assert p[1] is None and len(p[4]) == 4


# ----------------------------------------------------------------------------- profile capture
class _FakeProfiler:
    def __init__(self):
        self.calls = []

    def start_trace(self, path):
        self.calls.append(("start", os.path.basename(os.path.dirname(path))))

    def stop_trace(self):
        self.calls.append(("stop",))


def test_profile_capture_guard_matches(tmp_path):
    def run(capture_cls, handle):
        prof = _FakeProfiler()
        cap = capture_cls(base_dir=str(tmp_path), max_seconds=2.0, profiler=prof)
        statuses = []
        t = threading.Thread(target=lambda: statuses.append(handle("/debug/profile?seconds=0.3", cap)[0]))
        t.start()
        while not prof.calls:
            time.sleep(0.005)
        statuses.append(handle("/debug/profile?seconds=0.1", cap)[0])  # 409 while the first runs
        t.join(timeout=10)
        assert not t.is_alive()
        return (sorted(statuses), handle("/debug/profile?seconds=nope", cap)[0],
                handle("/debug/profile?seconds=5", cap)[0], handle("/other", cap), prof.calls)

    j = run(JProfileCapture, j_handle_profile)
    p = run(p_exporter.ProfileCapture, p_exporter.handle_profile_request)
    assert p == j
    assert p[0] == [200, 409] and p[1] == 400 == p[2] and p[3] is None


def test_torch_profile_capture_records_other_threads(tmp_path):
    """The port's capture bound to another thread (the engine loop): the
    profiler starts and stops there, between two of its steps, and that
    thread's ops land in the trace the capturing thread writes."""
    stop = threading.Event()
    calls = queue.Queue()

    def loop():
        while not stop.is_set():
            while not calls.empty():  # between steps, as EngineLoop.run_on_loop
                fn, box = calls.get()
                box["result"] = fn()
                box["done"].set()
            with torch.profiler.record_function("engine_step"):
                a = torch.ones(32, 32)
                (a @ a).sum()
            time.sleep(0.002)

    def run_on(fn):
        box = {"done": threading.Event()}
        calls.put((fn, box))
        assert box["done"].wait(10)
        return box["result"]

    t = threading.Thread(target=loop)
    t.start()
    try:
        status, _, body = p_exporter.handle_profile_request(
            "/debug/profile?seconds=0.3", p_exporter.ProfileCapture(base_dir=str(tmp_path)),
            profiler=p_exporter.TorchProfiler(run_on=run_on))
    finally:
        stop.set()
        t.join(timeout=10)
    assert status == 200 and not t.is_alive()
    path = json.loads(body)["path"]
    with open(os.path.join(path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"engine_step", "aten::mm"} <= names
