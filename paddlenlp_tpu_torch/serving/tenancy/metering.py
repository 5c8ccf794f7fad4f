"""Billing-grade usage metering: one structured record per finished request.

The :class:`UsageMeter` is the request-side half of serving-cost accounting.
The goodput ledger is the device-side truth — every fed position
decomposed into useful/padding/spec_rejected/rework under an exact
conservation invariant — but it has no notion of *who* a token belongs to.
The meter closes that gap: when the engine loop resolves a request (normal
finish, abort, engine_error quarantine, capacity reject, shutdown), it books
exactly one usage record keyed by the request's **trace id**, so a retry or
requeue-after-rebuild that resolves the same logical request twice (or the
same request booked by two replicas across a mid-stream failover) dedups to
one bill — in-process via the seen-id set, offline via
``tools/usage_report.py``'s record-id merge.

Record fields and their reconciliation contract:

- ``prompt_tokens`` / ``cached_tokens`` / ``completion_tokens``: the billable
  client view — prompt length, prefix-cache credit (booked ONCE, at first
  admission), and every token the client actually received (the handle's
  streamed list, which survives rebuild unfolding);
- ``useful_tokens``: the engine-attributed useful fed positions for this
  request, mirroring the per-tenant goodput fold token for token — summing
  it over sealed records equals the ledger's ``useful`` total exactly when
  every booked request finished on one engine (zero slack), and undershoots
  by at most the dead engine's completed work per retried request under
  chaos (the documented slack);
- ``kv_block_seconds``: the integral of held KV blocks over wall time
  (per-step checkpoints + finalized at free), ``adapter_slot_seconds``: wall
  time holding a real adapter-pool slot — the two residency costs a
  tokens-only price table misses;
- ``spec_drafted`` / ``spec_accepted``: speculative work billed per request;
- identity + shape: tenant, adapter_id, priority, finish_reason, retries,
  arrival/finish timestamps, e2e seconds, and the latency-attribution
  phase breakdown.

Durability is optional: with a :class:`~...observability.usage.UsageLedger`
attached every record also lands in the append-only JSONL segment store;
without one the meter still maintains the rolling aggregate that
``GET /debug/usage``, the router's ``/fleet/usage`` fold, and postmortem
bundles read. Set ``PDNLP_TPU_USAGE_DIR`` to arm durability from the
environment (the postmortem-dir pattern).
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import OrderedDict
from typing import Dict, Optional

from ...observability.usage import (RECORD_SCHEMA_VERSION, UsageLedger,
                                    empty_aggregate, fold_record)

__all__ = ["ENV_DIR", "UsageMeter"]

#: environment opt-in for the durable ledger (mirrors PDNLP_TPU_POSTMORTEM_DIR)
ENV_DIR = "PDNLP_TPU_USAGE_DIR"


class UsageMeter:
    """Per-replica usage bookkeeping: build, dedup, aggregate, persist.

    Thread-safety: records are booked on the engine-loop thread;
    :meth:`snapshot` runs on HTTP threads — one lock covers both (booking is
    per-finished-request, snapshots per-scrape: cold paths)."""

    def __init__(self, ledger: Optional[UsageLedger] = None, metrics=None,
                 max_seen_ids: int = 65536):
        self.ledger = ledger
        self.metrics = metrics
        self.max_seen_ids = int(max_seen_ids)
        self._lock = threading.Lock()
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self._agg = empty_aggregate()
        self._duplicates = 0
        self._seq = itertools.count()

    @classmethod
    def from_env(cls, metrics=None) -> "UsageMeter":
        """Meter with a durable ledger iff ``PDNLP_TPU_USAGE_DIR`` is set."""
        directory = os.environ.get(ENV_DIR, "").strip()
        ledger = UsageLedger(directory) if directory else None
        return cls(ledger=ledger, metrics=metrics)

    # ----------------------------------------------------------------- booking
    def record_finished(self, req, handle=None,
                        attribution: Optional[Dict] = None) -> Optional[Dict]:
        """Book usage for one resolved request. Returns the record, or None
        when this record id was already booked (idempotent re-resolution).
        Never raises into the engine loop: a ledger-write failure costs
        durability of one record, not the serving thread."""
        record = self._build(req, handle, attribution)
        with self._lock:
            rid = record["record_id"]
            if rid in self._seen:
                self._duplicates += 1
                return None
            self._seen[rid] = None
            while len(self._seen) > self.max_seen_ids:
                self._seen.popitem(last=False)
            fold_record(self._agg, record)
        if self.metrics is not None:
            self._count(record)
        if self.ledger is not None:
            try:
                self.ledger.append(record)
            except Exception:  # noqa: BLE001 — durability is best-effort here
                pass
        return record

    def _build(self, req, handle, attribution) -> Dict:
        trace = getattr(handle, "trace", None) or getattr(req, "trace", None)
        # engine req_ids restart per engine instance — without a trace they
        # are NOT unique over time, so mint a local id instead of deduping
        # two different requests into one bill
        record_id = trace or f"local-{next(self._seq)}"
        prompt_ids = getattr(req, "prompt_ids", None)
        n_prompt = 0 if prompt_ids is None else len(prompt_ids)
        if handle is not None:
            prompt_tokens = int(handle.prompt_len)
            # the handle's streamed list is every token the client received,
            # across preemption folds and engine rebuilds — the billing truth
            completion = len(handle._streamed)
        else:
            base = int(getattr(req, "base_prompt_len", 0) or n_prompt)
            prompt_tokens = base
            # a preemption folds generated tokens into prompt_ids: they were
            # delivered, so they bill as completion, not prompt
            completion = len(getattr(req, "output_ids", []) or []) \
                + max(n_prompt - base, 0)
        arrival_t = getattr(req, "arrival_t", None)
        finish_t = getattr(req, "finish_t", None)
        record = {
            "schema": RECORD_SCHEMA_VERSION,
            "record_id": record_id,
            "req_id": getattr(req, "req_id", -1),
            "tenant": getattr(req, "tenant", None) or "default",
            "adapter_id": getattr(req, "adapter_id", None)
            or getattr(handle, "adapter_id", None),
            "priority": getattr(req, "priority", "interactive"),
            "finish_reason": getattr(req, "finish_reason", None)
            or ("abort" if getattr(req, "aborted", False) else "unknown"),
            "retries": getattr(handle, "retries", 0) if handle is not None else 0,
            "prompt_tokens": prompt_tokens,
            "cached_tokens": int(getattr(req, "cached_tokens", 0) or 0),
            "completion_tokens": int(completion),
            "useful_tokens": int(getattr(req, "useful_tokens", 0) or 0),
            "spec_drafted": int(getattr(req, "spec_drafted", 0) or 0),
            "spec_accepted": int(getattr(req, "spec_accepted", 0) or 0),
            "kv_block_seconds": round(float(
                getattr(req, "kv_block_seconds", 0.0) or 0.0), 6),
            "adapter_slot_seconds": round(float(
                getattr(req, "adapter_slot_seconds", 0.0) or 0.0), 6),
            "arrival_t": arrival_t,
            "finish_t": finish_t,
            "e2e_s": round(finish_t - arrival_t, 6)
            if arrival_t is not None and finish_t is not None else None,
            "attribution": attribution,
        }
        if self.ledger is not None:
            record["replica"] = self.ledger.replica
        return record

    def _count(self, record: Dict):
        labels = dict(tenant=record["tenant"],
                      adapter=record["adapter_id"] or "base")
        for kind, field in (("prompt", "prompt_tokens"),
                            ("cached", "cached_tokens"),
                            ("completion", "completion_tokens")):
            if record[field]:
                self.metrics.usage_tokens.inc(record[field], kind=kind, **labels)
        self.metrics.usage_records.inc(tenant=record["tenant"])

    # ----------------------------------------------------------------- views
    def snapshot(self) -> Dict:
        """The ``GET /debug/usage`` document: rolling aggregate + ledger
        durability stats. Matches (by construction) what folding this
        replica's sealed+open segments would produce."""
        with self._lock:
            doc = {
                "tier": "serving",
                "schema": RECORD_SCHEMA_VERSION,
                "records": self._agg["records"],
                "totals": dict(self._agg["totals"]),
                "tenants": {t: dict(b) for t, b in self._agg["tenants"].items()},
                "adapters": {a: dict(b) for a, b in self._agg["adapters"].items()},
                "duplicates_suppressed": self._duplicates,
            }
        doc["ledger"] = self.ledger.stats() if self.ledger is not None else None
        return doc

    def close(self):
        """Seal the durable ledger (shutdown): sealed segments are what the
        offline aggregator merges."""
        if self.ledger is not None:
            self.ledger.close()
