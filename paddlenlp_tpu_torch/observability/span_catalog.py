"""Trace span/instant name catalog — the stable vocabulary of the tracer.

Span names are string API the same way metric names and fault-point names
are: Perfetto queries, ``/debug/trace?trace=`` tooling, the README's
observability tables and the SLO runbooks all refer to spans by name, so a
rename or an undocumented addition is a silent break for every saved query.
``tools/analyze`` (the ``span-catalog`` checker) enforces both directions:
every literal name passed to ``TRACER.span/instant/add_span`` in
the package must have an entry here, and every entry must have a call
site (a dynamic-name call site declares its names with an inline
``# span-names: a b c`` comment).

Grouped by emitting tier. Keep docs to one line — they are the catalog, not
the design doc (that lives in the emitting module's docstring).

This module stays stdlib-only (no torch, no package-relative imports). A
copy of ``paddlenlp_tpu/observability/span_catalog.py``; every entry but the
disaggregated backend's ``kv_migrate``/``kv_migrated`` has its call site in
the port (the router's in ``serving/router``; the disaggregated backend is
ROADMAP Queue 1 item 12b).
"""

from __future__ import annotations

__all__ = ["SPAN_CATALOG"]

SPAN_CATALOG = {
    # ------------------------------------------------------------- engine (cat="engine")
    "admission": "waiting->slot binding + KV allocation for one engine step (also the scheduler-side admission span, cat=scheduler)",
    "prefix_cache": "prefix-cache match/COW bookkeeping + owed device block copies during admission",
    "prefill": "batched monolithic prompt prefill, one span per padded suffix-length bucket (also the retrospective per-request prefill phase)",
    "mixed_step": "one ragged mixed prefill-chunk + decode forward (chunked prefill)",
    "decode": "multi-token decode call over all running slots (also the retrospective per-request decode phase)",
    "spec_propose": "speculative-decoding draft proposal (ngram or draft model)",
    "spec_verify": "speculative-decoding batched verify forward",
    "sampling": "host-side rejection-sampling acceptance for one request (spec sample mode)",
    "kv_alloc": "instant: KV blocks allocated for an admitted request (cached_tokens = prefix-cache hit)",
    "kv_free": "instant: a request's KV blocks released (finish/abort/preempt)",
    "preempt": "instant: KV exhaustion evicted the youngest sequence for recompute-requeue",
    "kv_migrate": "dispatch of one sequence's prefill->decode KV-block migration (disaggregated backend)",
    "kv_migrated": "instant: a sequence's migrated blocks landed in the decode pool; it is now decode-eligible",
    "kv_spill": "one batched D2H gather of LRU-evicted prefix blocks into the host KV tier",
    "kv_promote": "dispatch of one request's host->device KV promotion copy ahead of its prefill",
    "kv_promoted": "instant: a request's promoted blocks landed in the device pool; its deferred prefill proceeds",
    # ------------------------------------------------------------- engine loop / supervisor
    "engine_failure": "instant: engine.step() raised; the loop is entering DEGRADED",
    "engine_degraded": "one DEGRADED window: triage -> backoff -> rebuild -> requeue",
    "slot_quarantine": "one slot-level partial recovery: poisoned request released + failed, engine kept running",
    "request": "retrospective whole-request span (arrival -> finish) under the request's trace id",
    "queue": "retrospective per-request wait from arrival to slot admission",
    # ------------------------------------------------------------- scheduler
    "admission_rejected": "instant: scheduler shed a submission (reason=draining|degraded|saturated|deadline|shed)",
    "brownout": "instant: the overload-brownout ladder changed effective level (prev -> level, reason=saturation|slo_fast_burn|push)",
    # ------------------------------------------------------------- router
    "route": "routing decision for one request (snapshot + policy ordering)",
    "router_request": "whole router-side request span (forward + stream relay)",
    "reroute": "instant: attempt moved to the next candidate before anything was relayed",
    "failover": "accepted-then-failed pre-token resubmission onto another replica",
    "replica_state": "instant: pool state machine moved a replica (prev -> state)",
    "membership": "instant: replica membership event (op=add/drain/drained/drain_expired/drain_evict/remove; op=drain_direct on the replica's own scheduler)",
    "hedge": "instant: hedged-stream lifecycle event (outcome=fired/capped/primary_won/hedge_won/failed)",
    # ------------------------------------------------------------- serving api
    "trace_adopted": "instant: replica adopted an inbound router traceparent instead of minting req-N",
    # ------------------------------------------------------------- trainer
    "train_step": "one optimizer step (forward/backward/update) on the trainer loop",
    "evaluate": "one evaluation pass over the eval dataset",
    "checkpoint": "checkpoint save (stage + manifest + commit rename)",
    "block_until_ready": "device sync inside a trainer timer stop (host waited on the device here)",
    # ------------------------------------------------------------- profiler
    "profiler_window_start": "instant: profiler capture window opened",
    "profiler_window_stop": "instant: profiler capture window closed",
}
