"""Flight-recorder decision-event catalog — the stable vocabulary of *why*.

Spans and metrics record *that* phases happened; the flight recorder records
*why* scheduling decisions went the way they did (admission deferred, victim
preempted, migration gated, request hedged). Event names are string API the
same way span names, metric names and fault-point names are: postmortem
bundles are grepped by event name, ``tools/postmortem.py`` renders decision
trails from them, and runbooks refer to them — so every literal name passed
to ``RECORDER.record(...)`` must have an entry here, and every entry must
have a call site. ``tools/analyze`` (the ``event-catalog`` checker) enforces
both directions, exactly like the span catalog.

Events that carry a ``reason`` field draw it from a closed enum
(:data:`EVENT_REASONS`) — the recorder validates membership at record time so
a typo'd reason fails a test instead of silently forking the vocabulary a
dashboard filters on.

This module stays stdlib-only (no torch, no package-relative imports). A
copy of ``paddlenlp_tpu/observability/event_catalog.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["EVENT_CATALOG", "EVENT_REASONS"]

EVENT_CATALOG: Dict[str, str] = {
    # ------------------------------------------------------------- engine scheduling
    "admit.accept": "a waiting request was bound to a slot and its KV blocks allocated (fields: slot, prompt_len, cached_tokens)",
    "admit.defer": "the head-of-queue request was deferred by an admission gate; recorded once per wait episode (reason=kv_pressure|prefill_gate|adapter_pressure|tenant_kv_share)",
    "admit.reject": "a request that can never fit was rejected terminally with finish_reason=capacity (reason=capacity)",
    "preempt": "KV exhaustion evicted the youngest sequence for recompute-requeue (reason=decode_growth|mixed_capacity|spec_reserve)",
    "chunk.grant": "one mid-prefill slot drew prompt tokens from the mixed-step chunk budget (fields: tokens, budget_left)",
    "migrate.start": "one sequence's prefill->decode KV-block migration was dispatched (fields: blocks, inflight)",
    "migrate.defer": "the head pending migration was deferred; recorded once per wait episode (reason=decode_pressure|inflight_limit)",
    "migrate.land": "a sequence's migrated blocks landed in the decode pool; it is now decode-eligible (fields: blocks, polls)",
    # ------------------------------------------------------------- hierarchical KV (host tier)
    "spill.batch": "LRU-evicted prefix blocks were gathered D2H in one batch and registered in the host KV tier (fields: blocks, resident)",
    "spill.drop": "a spill batch failed and was dropped — the evicted blocks are simply not cached, the pre-tier behavior (fields: blocks, error)",
    "promote.start": "an admitted request's prefix matched host-tier blocks; their H2D promotion copy was dispatched ahead of prefill (fields: blocks, bytes)",
    "promote.land": "a request's promoted blocks landed in the device pool; its deferred prefill proceeds (fields: blocks, polls)",
    "promote.fail": "a promotion failed; the request fell back token-exactly to cold re-prefill of the span (fields: blocks, error)",
    # ------------------------------------------------------------- scheduler (admission control)
    "sched.reject": "the scheduler shed a submission before it reached the engine (reason=saturated|draining|degraded|deadline|shed|tenant_quota -> HTTP 429/503)",
    # ------------------------------------------------------------- brownout (overload degradation ladder)
    "brownout.enter": "the replica entered brownout level 1+ from normal operation (reason=saturation|slo_fast_burn)",
    "brownout.step": "the brownout ladder moved one level while already browned out (fields: prev, level, direction)",
    "brownout.exit": "sustained calm de-escalated the replica back to normal operation (hysteresis-guarded; fields: held_s)",
    # ------------------------------------------------------------- engine loop / supervisor
    "supervisor.degraded": "engine.step() raised without per-request attribution; the loop entered DEGRADED and triaged in-flight work",
    "supervisor.recovered": "the engine was rebuilt and stashed requests requeued; the loop left DEGRADED (fields: attempts, requeued, failed)",
    "supervisor.quarantine": "a poisoned request was quarantined at slot level (KV released, handle failed, engine kept running)",
    # ------------------------------------------------------------- router
    "router.reroute": "a forward attempt moved to the next candidate before anything was relayed (429/503/connect failure)",
    "router.failover": "an accepted-then-failed request was transparently resubmitted to another replica pre-token",
    "router.hedge_fire": "the first-token budget expired with no usable event; a shadow leg was launched on the next candidate",
    "router.hedge_commit": "one hedged leg produced the first usable event and was committed (fields: outcome=primary_won|hedge_won)",
    "router.hedge_abort": "the losing hedged leg was torn down (socket closed; /v1/abort when its upstream id was known)",
    "router.drain_evict": "a drain outlived its deadline; a token-less stream pinned to the draining replica was broken into pre-token failover",
    # ------------------------------------------------------------- weight swap / rollout
    "swap.begin": "a weight-swap command reached the engine loop and quiesce began (fields: version, mode=finish_old|pause_resume)",
    "swap.done": "new params installed, canary passed, cache epoch bumped; the replica serves the new version (fields: version, resumed)",
    "swap.rollback": "the swap failed after quiesce; the retained old params were restored and the replica kept serving (reason=swap_failed|canary_mismatch)",
    "rollout.start": "the router began a rolling fleet weight rollout (fields: version, replicas)",
    "rollout.replica": "one replica completed drain -> swap -> canary -> rejoin under the new version (fields: replica, wall_s)",
    "rollout.abort": "a replica failed its swap/rejoin; the rollout stopped and already-swapped replicas were rolled back (reason=swap_failed|drain_timeout|rejoin_timeout|rollback_failed)",
    "rollout.done": "every replica converged on the new weights version (fields: version, wall_s)",
    "router.version_skew": "a mid-stream failover was refused because the surviving candidates run a different weights version; the stream was terminated in-band (fields: replica, version)",
    # ------------------------------------------------------------- autoscaler (fleet policy loop)
    "scale.up": "the autoscaler grew the fleet after sustained overload (fields: added, replicas)",
    "scale.down": "the autoscaler drained + removed replicas after sustained underload (fields: removed, replicas)",
    "scale.replace": "a DOWN replica was force-removed and a replacement provisioned (fields: replica)",
    "scale.hold": "a scale action was suppressed; recorded once per episode (reason=cooldown|hysteresis|max_envelope|min_envelope|provision_backoff)",
}

#: closed ``reason`` vocabularies for events that carry one. The recorder
#: validates membership at record time; events absent here take no reason.
EVENT_REASONS: Dict[str, Tuple[str, ...]] = {
    "admit.defer": ("kv_pressure", "prefill_gate", "adapter_pressure",
                    "tenant_kv_share"),
    "admit.reject": ("capacity",),
    "preempt": ("decode_growth", "mixed_capacity", "spec_reserve"),
    "migrate.defer": ("decode_pressure", "inflight_limit"),
    "sched.reject": ("saturated", "draining", "degraded", "deadline", "shed",
                     "tenant_quota"),
    "brownout.enter": ("saturation", "slo_fast_burn"),
    "swap.rollback": ("swap_failed", "canary_mismatch"),
    "rollout.abort": ("swap_failed", "drain_timeout", "rejoin_timeout",
                      "rollback_failed"),
    "scale.hold": ("cooldown", "hysteresis", "max_envelope", "min_envelope",
                   "provision_backoff"),
}
