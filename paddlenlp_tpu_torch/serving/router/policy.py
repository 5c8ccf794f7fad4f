"""Routing policies: least-loaded shedding and consistent-hash prefix affinity.

A policy turns the pool's replica snapshots into an **ordered candidate
list** — the proxy walks it front-to-back, so position 0 is the routing
decision and the tail is the failover order. Policies are pure functions of
their inputs (no hidden state beyond the memoized hash ring), which is what
makes the prefix-affinity determinism testable: the same prompt prefix over
the same replica set always yields the same candidate order.

**Effective load score.** ``inflight + queue_depth + kv_utilization``: the
replica's admission-window occupancy, its engine-side waiting queue, and the
KV-block pressure (0..1 — a tiebreaker between replicas with equal request
counts, and the early-warning signal before preemption thrash).

**Prefix affinity.** Requests sharing a prompt prefix hash to the same point
on a consistent-hash ring, so a shared-prefix burst (few-shot template, long
system prompt) lands on one replica where the planned prefix cache can serve
it warm. The ring walk also defines the failover order: when the pinned
replica is DOWN/excluded, every client of that prefix agrees on the *same*
next replica — the prefix stays co-located even through an incident. Ring
membership changes move only ~1/N of prefixes (the point of consistent
hashing over modulo placement).

A copy of ``paddlenlp_tpu/serving/router/policy.py``: the ring hashes
with ``hashlib``, so both packages place a key on the same replica.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import FrozenSet, Iterable, List, Optional, Sequence, Tuple, Union

from .pool import DEGRADED, DOWN, HEALTHY, RECOVERING, ReplicaSnapshot

__all__ = ["load_score", "LeastLoadedPolicy", "PrefixAffinityPolicy", "HashRing",
           "resolve_policy"]

Prompt = Union[str, Sequence[int], None]

#: candidate preference by state: HEALTHY first, probational RECOVERING next,
#: DEGRADED only when nothing better exists (its 503 breaker will bounce the
#: attempt anyway, but a breaker can lift between poll and forward). DOWN is
#: never offered.
_STATE_RANK = {HEALTHY: 0, RECOVERING: 1, DEGRADED: 2}


def load_score(snap: ReplicaSnapshot) -> float:
    """Effective load: admission inflight + engine queue depth + KV utilization."""
    return snap.inflight + snap.queue_depth + snap.kv_utilization


def _eligible(snapshots: Iterable[ReplicaSnapshot],
              exclude: FrozenSet[str]) -> List[ReplicaSnapshot]:
    # DOWN is unreachable; a draining replica is healthy but leaving — it
    # finishes its in-flight streams and must never be offered NEW requests
    return [s for s in snapshots
            if s.state != DOWN and not s.draining and s.id not in exclude]


class LeastLoadedPolicy:
    """Order candidates by (state preference, effective load score, id).

    The id tiebreaker keeps the order total and deterministic so tests and
    failover behave identically across runs."""

    name = "least_loaded"

    def select(self, snapshots: Sequence[ReplicaSnapshot], prompt: Prompt = None,
               exclude: FrozenSet[str] = frozenset(),
               adapter_id: Optional[str] = None,
               conversation: Optional[str] = None) -> List[ReplicaSnapshot]:
        return sorted(_eligible(snapshots, exclude),
                      key=lambda s: (_STATE_RANK.get(s.state, 3), load_score(s), s.id))


class HashRing:
    """Consistent-hash ring over replica ids with virtual nodes.

    ``vnodes`` points per replica smooth the arc lengths so one replica cannot
    own a disproportionate share of the prefix space; md5 is used for its
    distribution quality, not security."""

    def __init__(self, ids: Sequence[str], vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.ids = tuple(ids)
        points: List[Tuple[int, str]] = []
        for rid in self.ids:
            for v in range(vnodes):
                points.append((self._hash(f"{rid}#{v}"), rid))
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")

    def ordered(self, key: str) -> List[str]:
        """Distinct replica ids in ring order starting at ``key``'s successor:
        position 0 is the pinned replica, the rest is the agreed failover walk."""
        if not self._points:
            return []
        start = bisect.bisect_left(self._keys, self._hash(key)) % len(self._points)
        seen, out = set(), []
        for i in range(len(self._points)):
            rid = self._points[(start + i) % len(self._points)][1]
            if rid not in seen:
                seen.add(rid)
                out.append(rid)
            if len(seen) == len(self.ids):
                break
        return out


class PrefixAffinityPolicy:
    """Pin requests sharing a prompt prefix to one replica via the hash ring.

    ``prefix_tokens`` bounds the affinity key: the first N token ids (or, for
    raw string prompts, the first ``4 * N`` characters — roughly the same text
    span) so that requests differing only in their tail still co-locate. The
    ring is rebuilt only when the replica id set changes.

    **Weighted spill.** A popular prefix can turn its pinned replica into a
    hot spot — and an autoscaler that just grew the fleet would watch the new
    replicas idle while the pin melts. ``spill_load_score`` bounds how hot a
    pin may run: when the pinned replica's :func:`load_score` exceeds it, the
    request spills to the next ring candidate whose score is still under the
    threshold (the *agreed* failover order, so every client of the prefix
    spills to the SAME replica — the prefix stays co-located on two replicas
    instead of scattering). When every candidate is equally hot the pin
    stands: bouncing between uniformly-loaded replicas would only shed the
    cache benefit. ``None`` disables spilling.

    **Adapter affinity.** A request carrying an ``adapter_id`` hashes on
    ``a:<adapter_id>`` instead of its prompt prefix: every request for one
    LoRA adapter lands on the same replica, whose registry pool then serves
    the adapter warm (one hot-load instead of N, and the replica's prefix
    cache — keyed ``(adapter_id, tokens)`` — stays coherent per adapter).
    The same weighted spill bounds a hot adapter pin, and the ring walk is
    the agreed failover/spill order, so a melting pin co-locates the adapter
    on exactly one more replica.

    **Conversation affinity.** A ``/v1/chat/completions`` request carrying a
    ``conversation`` key hashes on ``c:<conversation>`` — the strongest
    affinity signal, outranking adapter and prompt-prefix keys. Every turn of
    a conversation lands on the replica whose hierarchical prefix cache holds
    the previous turns' prompt AND completion KV (device or host tier), so
    turn N+1 re-prefills only its new user message even across HBM cache
    pressure. The ring walk and weighted spill apply unchanged."""

    name = "prefix_affinity"

    def __init__(self, prefix_tokens: int = 16, vnodes: int = 64,
                 spill_load_score: Optional[float] = 8.0):
        if prefix_tokens < 1:
            raise ValueError("prefix_tokens must be >= 1")
        if spill_load_score is not None and spill_load_score <= 0:
            raise ValueError("spill_load_score must be > 0 (None disables)")
        self.prefix_tokens = prefix_tokens
        self.vnodes = vnodes
        self.spill_load_score = spill_load_score
        self._ring: Optional[HashRing] = None
        self._ring_ids: Optional[Tuple[str, ...]] = None
        self._fallback = LeastLoadedPolicy()

    def prefix_key(self, prompt: Prompt, adapter_id: Optional[str] = None,
                   conversation: Optional[str] = None) -> Optional[str]:
        if conversation:
            return "c:" + conversation
        if adapter_id:
            return "a:" + adapter_id
        if prompt is None:
            return None
        if isinstance(prompt, str):
            return "s:" + prompt[: 4 * self.prefix_tokens]
        try:
            return "t:" + ",".join(str(int(t)) for t in list(prompt)[: self.prefix_tokens])
        except (TypeError, ValueError):
            return None

    def _ring_for(self, snapshots: Sequence[ReplicaSnapshot]) -> HashRing:
        ids = tuple(sorted(s.id for s in snapshots))
        if self._ring is None or self._ring_ids != ids:
            self._ring = HashRing(ids, vnodes=self.vnodes)
            self._ring_ids = ids
        return self._ring

    def select(self, snapshots: Sequence[ReplicaSnapshot], prompt: Prompt = None,
               exclude: FrozenSet[str] = frozenset(),
               adapter_id: Optional[str] = None,
               conversation: Optional[str] = None) -> List[ReplicaSnapshot]:
        key = self.prefix_key(prompt, adapter_id, conversation)
        if key is None:
            return self._fallback.select(snapshots, prompt, exclude)
        # ring membership is computed over ALL replicas (not just eligible
        # ones): a replica's arc must not migrate while it is merely DOWN, or
        # its prefixes would re-pin twice — once leaving, once coming back
        ring_order = {rid: i for i, rid in enumerate(self._ring_for(snapshots).ordered(key))}
        eligible = _eligible(snapshots, exclude)
        # the ring walk is the affinity chain; state rank still outranks it so
        # a DEGRADED pinned replica yields to the next healthy ring member
        ordered = sorted(eligible,
                         key=lambda s: (_STATE_RANK.get(s.state, 3),
                                        ring_order.get(s.id, len(ring_order)), s.id))
        # weighted spill: a too-hot pin yields to the FIRST ring successor
        # still under the threshold (same state rank — a spill must not trade
        # cache warmth for a degraded replica); the successor moves to the
        # front and the rest of the walk keeps its order, so the failover
        # chain stays agreed across clients
        spill = self.spill_load_score
        if spill is not None and len(ordered) > 1 and load_score(ordered[0]) > spill:
            pinned_rank = _STATE_RANK.get(ordered[0].state, 3)
            for i in range(1, len(ordered)):
                cand = ordered[i]
                if _STATE_RANK.get(cand.state, 3) != pinned_rank:
                    break  # never spill onto a worse-state replica
                if load_score(cand) <= spill:
                    ordered.insert(0, ordered.pop(i))
                    break
        return ordered


def resolve_policy(policy) -> object:
    """``"least_loaded"`` / ``"prefix_affinity"`` / a policy instance → instance."""
    if policy is None:
        return LeastLoadedPolicy()
    if isinstance(policy, str):
        if policy == "least_loaded":
            return LeastLoadedPolicy()
        if policy == "prefix_affinity":
            return PrefixAffinityPolicy()
        raise ValueError(f"unknown routing policy {policy!r}; "
                         "use 'least_loaded' or 'prefix_affinity'")
    if not hasattr(policy, "select"):
        raise TypeError(f"policy {policy!r} has no select()")
    return policy
