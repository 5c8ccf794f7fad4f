"""Goodput ledger: per-step device-efficiency accounting for serving.

The serving runtime can trace *when* phases happened (span tracer), *why*
decisions went the way they did (flight recorder), and *where* a request's
latency went (attribution) — but not what fraction of each device step was
useful work. This module closes that gap with an exact token-conservation
ledger every backend step reports into:

``fed == useful + padding + spec_rejected + rework``  (exact, per step)

- **fed** — token *positions* the device program actually processed (padded
  launch geometry, not the scheduler's intent: a ``[B, T]`` mixed launch fed
  ``B*T`` positions regardless of how many rows were live);
- **useful** — positions that built new KV or emitted a kept token (prompt
  prefill, final-chunk/decode samples, accepted speculative tokens);
- **padding** — bucket/pow2 pad rows and columns, dead ragged rows, idle
  decode-batch slots: device cycles burnt on zeros;
- **spec_rejected** — drafted-but-rejected speculative positions
  (``drafted - accepted``, the acceptance-rate complement);
- **rework** — positions fed *again* for work already done once: re-prefill
  after a preemption or supervisor requeue, the prefix-cache COW tail token,
  and decode-stage penalty-count re-seeds on KV migration.

The ledger is engine-owned and loop-thread-confined like ``chunk_stats``:
writes happen only between backend calls on the engine-loop thread; readers
(pull gauges, ``/debug/efficiency``, ``stats()``) see monotone ints that are
at worst a step stale. :meth:`GoodputLedger.record` *validates* conservation
and raises on violation — the tier-1 parity suite runs real workloads over
every backend and the invariant failing is a step failure, not a silent
drift.

On top of the token ledger:

- **step anatomy** — host gap between consecutive busy steps vs device time
  inside the step (the timestamps already bracketing ``step()``), exported as
  ``paddlenlp_serving_step_gap_seconds`` and percentiled on
  ``/debug/efficiency``;
- **launch-geometry cardinality** — the distinct padded launch shapes seen;
- **serving FLOPs estimation** — ``estimate_model_flops_per_token`` (2 *
  params, from config arithmetic) and the per-device peak FLOPs keyed on the
  CUDA device name (``utils/env.py``), so the MFU reads real on an H100 and
  NaN elsewhere (a CPU run must not report a fake MFU).

PyTorch port of ``paddlenlp_tpu/observability/goodput.py``. PyTorch runs
eagerly and compiles nothing, so the JAX package's ``jax.monitoring`` compile
listener and its per-program compile counts are not part of the port.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

from ..utils.env import device_peak_flops

__all__ = [
    "GoodputLedger",
    "WASTE_KINDS",
    "REWORK_KINDS",
    "estimate_model_flops_per_token",
    "device_peak_flops",
    "efficiency_doc",
]

#: the ``{kind}`` label values of ``paddlenlp_serving_wasted_tokens_total`` —
#: the three non-useful buckets of the conservation invariant
WASTE_KINDS = ("padding", "spec_rejected", "rework")

#: rework sub-kinds (``/debug/efficiency`` detail; the metric folds them all
#: under ``kind="rework"``)
REWORK_KINDS = ("preempt_refill", "requeue_refill", "cow_token", "migration_reseed")

#: step-program vocabulary the ledger accounts by
STEP_KINDS = ("prefill", "decode", "mixed", "verify", "reseed")


class GoodputLedger:
    """Monotone per-engine token/efficiency accounting.

    **Concurrency model.** All mutation happens on the engine-loop thread
    (the only thread that runs backend steps); HTTP/metrics threads only read
    plain ints and floats — a momentarily torn read skews one scrape by one
    step, the same contract ``chunk_stats`` and ``spec_stats`` already have.
    """

    def __init__(self, flops_per_token: float = float("nan"),
                 peak_flops: float = float("nan")):
        self.totals: Dict[str, int] = {
            "fed": 0, "useful": 0, "padding": 0, "spec_rejected": 0, "rework": 0}
        #: padding decomposed by the step program that padded
        self.padding_by: Dict[str, int] = {k: 0 for k in STEP_KINDS}
        #: rework decomposed by cause
        self.rework_by: Dict[str, int] = {k: 0 for k in REWORK_KINDS}
        #: per-program (kind -> [steps, fed]) launch accounting
        self.by_kind: Dict[str, Dict[str, int]] = {
            k: {"steps": 0, "fed": 0, "useful": 0} for k in STEP_KINDS}
        #: distinct jit launch geometries seen — live retrace-cardinality
        self.shape_buckets: set = set()
        # step-time anatomy accumulators (note_step)
        self.steps = 0
        self.gap_seconds_total = 0.0
        self.device_seconds_total = 0.0
        self.host_seconds_total = 0.0
        # wall anchors for the lifetime-MFU denominator
        self._first_record_t: Optional[float] = None
        self._last_record_t: Optional[float] = None
        self.flops_per_token = float(flops_per_token)
        self.peak_flops = float(peak_flops)

    # ------------------------------------------------------------- recording
    def record(self, kind: str, fed: int, useful: int, padding: int = 0,
               spec_rejected: int = 0, rework: int = 0,
               rework_by: Optional[Dict[str, int]] = None):
        """Account one device launch. Raises ``ValueError`` when the
        decomposition breaks conservation or goes negative — the invariant is
        enforced at record time, so an accounting bug is a loud step failure
        the supervisor surfaces, never silent ledger drift."""
        if kind not in self.by_kind:
            raise ValueError(f"unknown step kind {kind!r} (want one of {STEP_KINDS})")
        parts = {"fed": fed, "useful": useful, "padding": padding,
                 "spec_rejected": spec_rejected, "rework": rework}
        for name, v in parts.items():
            if v < 0:
                raise ValueError(
                    f"goodput conservation violated in {kind!r}: {name}={v} < 0 "
                    f"({parts})")
        if fed != useful + padding + spec_rejected + rework:
            raise ValueError(
                f"goodput conservation violated in {kind!r}: fed={fed} != "
                f"useful+padding+spec_rejected+rework="
                f"{useful + padding + spec_rejected + rework} ({parts})")
        if rework_by:
            if sum(rework_by.values()) != rework:
                raise ValueError(
                    f"goodput rework attribution in {kind!r} does not sum: "
                    f"{rework_by} != rework={rework}")
            for sub, v in rework_by.items():
                self.rework_by[sub] = self.rework_by.get(sub, 0) + v
        elif rework:
            self.rework_by["preempt_refill"] += rework
        self.totals["fed"] += fed
        self.totals["useful"] += useful
        self.totals["padding"] += padding
        self.totals["spec_rejected"] += spec_rejected
        self.totals["rework"] += rework
        self.padding_by[kind] += padding
        bk = self.by_kind[kind]
        bk["steps"] += 1
        bk["fed"] += fed
        bk["useful"] += useful
        now = time.time()
        if self._first_record_t is None:
            self._first_record_t = now
        self._last_record_t = now

    def note_shape(self, key: Tuple):
        """Register one jit launch geometry (program + bucketed dims). The
        set's cardinality is the live shape-bucket gauge: it growing without
        bound is the retrace storm the pow2 bucketing exists to prevent."""
        self.shape_buckets.add(key)

    def note_step(self, gap_s: float, device_s: float, host_s: float):
        """One engine step's time anatomy: ``gap_s`` = host time since the
        previous busy step ended (loop overhead: command drain, deadlines,
        metrics), ``device_s`` = time inside backend calls, ``host_s`` = the
        step's own scheduling time around them."""
        self.steps += 1
        self.gap_seconds_total += max(gap_s, 0.0)
        self.device_seconds_total += max(device_s, 0.0)
        self.host_seconds_total += max(host_s, 0.0)

    # ------------------------------------------------------------- readouts
    def ratio(self) -> float:
        """Lifetime goodput: useful / fed (1.0 before any step — an idle
        replica wastes nothing)."""
        fed = self.totals["fed"]
        return self.totals["useful"] / fed if fed else 1.0

    def mfu(self) -> float:
        """Estimated model-FLOPs utilization over the busy lifetime: useful
        tokens * flops-per-token over elapsed wall * peak device FLOPs. NaN
        when the device peak is unknown (CPU smoke runs) or nothing ran."""
        if self._first_record_t is None or self._last_record_t is None:
            return float("nan")
        elapsed = self._last_record_t - self._first_record_t
        if not (elapsed > 0) or math.isnan(self.peak_flops) \
                or math.isnan(self.flops_per_token) or self.peak_flops <= 0:
            return float("nan")
        return (self.totals["useful"] * self.flops_per_token) / (elapsed * self.peak_flops)

    def verify_conservation(self) -> bool:
        """True iff the lifetime totals still satisfy the invariant (they do
        by construction; the parity tests call this as a belt on record()'s
        suspenders)."""
        t = self.totals
        return t["fed"] == t["useful"] + t["padding"] + t["spec_rejected"] + t["rework"] \
            and all(v >= 0 for v in t.values()) \
            and sum(self.padding_by.values()) == t["padding"] \
            and sum(self.rework_by.values()) == t["rework"]

    def snapshot(self) -> Dict:
        """Point-in-time ledger view for ``stats()`` / postmortem bundles /
        ``/debug/efficiency``. Readable from any thread: the count dicts have
        fixed key sets after init."""
        return {
            "totals": dict(self.totals),
            "goodput_ratio": round(self.ratio(), 6),
            "padding_by": {k: v for k, v in self.padding_by.items() if v},
            "rework_by": {k: v for k, v in self.rework_by.items() if v},
            "by_kind": {k: dict(v) for k, v in self.by_kind.items() if v["steps"]},
            "shape_buckets": len(self.shape_buckets),
            "steps": self.steps,
            "step_seconds": {
                "gap_total": round(self.gap_seconds_total, 4),
                "device_total": round(self.device_seconds_total, 4),
                "host_total": round(self.host_seconds_total, 4),
            },
        }


# ---------------------------------------------------------------- flops model
def estimate_model_flops_per_token(config) -> float:
    """~2 * parameter count: the standard dense decoder forward estimate
    (attention's context-length-dependent term is deliberately excluded — the
    MFU gauge is a capacity-planning signal, not a profiler). Pure config
    arithmetic; NaN when the config lacks the dense-decoder fields."""
    try:
        h = int(config.hidden_size)
        layers = int(config.num_hidden_layers)
        vocab = int(config.vocab_size)
        inter = int(getattr(config, "intermediate_size", 4 * h))
        n_heads = int(getattr(config, "num_attention_heads", 1))
        n_kv = int(getattr(config, "num_key_value_heads", n_heads) or n_heads)
    except (AttributeError, TypeError, ValueError):
        return float("nan")
    if h <= 0 or layers <= 0 or vocab <= 0 or n_heads <= 0:
        return float("nan")
    # q + o full-size, k + v scaled by the GQA ratio, 3 MLP mats, embed+head
    attn = h * h * (2 + 2 * n_kv / n_heads)
    mlp = 3 * h * inter
    params = vocab * h * 2 + layers * (attn + mlp)
    return 2.0 * params


# ---------------------------------------------------------------- doc helper
def _pct(values, q: float) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    return s[min(int(q * len(s)), len(s) - 1)]


def efficiency_doc(ledger: Optional[GoodputLedger], step_times=(),
                   tier: str = "serving", extra: Optional[Dict] = None) -> Dict:
    """The ``GET /debug/efficiency`` document: ledger snapshot + percentiled
    step anatomy (``step_times`` = iterable of ``(seq, gap_s, device_s,
    host_s)`` ring entries). NaN floats serialize as ``null`` (strict-JSON
    consumers must parse the doc)."""
    doc: Dict = {"tier": tier}
    if ledger is not None:
        doc["ledger"] = ledger.snapshot()
        doc["goodput_ratio"] = ledger.ratio()
        mfu = ledger.mfu()
        doc["mfu"] = None if math.isnan(mfu) else mfu
        doc["flops_per_token"] = (None if math.isnan(ledger.flops_per_token)
                                  else ledger.flops_per_token)
        doc["device_peak_flops"] = (None if math.isnan(ledger.peak_flops)
                                    else ledger.peak_flops)
    times = list(step_times)
    if times:
        # negative gap = unmeasured (first step / post-idle): the loop slept
        # on purpose, so those entries must not drag the gap percentiles down
        gaps = [t[1] for t in times if t[1] >= 0]
        devs = [t[2] for t in times]
        hosts = [t[3] for t in times]
        doc["step_anatomy"] = {
            "window_steps": len(times),
            # null when every gap in the window is unmeasured (all post-idle)
            # — the mfu NaN-means-unknown convention, never a fake 0.0
            "gap_p50_ms": round(_pct(gaps, 0.5) * 1e3, 3) if gaps else None,
            "gap_p99_ms": round(_pct(gaps, 0.99) * 1e3, 3) if gaps else None,
            "device_p50_ms": round(_pct(devs, 0.5) * 1e3, 3),
            "device_p99_ms": round(_pct(devs, 0.99) * 1e3, 3),
            "host_p50_ms": round(_pct(hosts, 0.5) * 1e3, 3),
            "host_p99_ms": round(_pct(hosts, 0.99) * 1e3, 3),
        }
    if extra:
        doc.update(extra)
    return doc
