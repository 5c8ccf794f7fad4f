"""Deterministic fault-injection harness: named fault points with trigger specs.

Large-scale training/serving treats preemption and partial failure as the
common case; the only way recovery paths stay honest is to execute them in
tier-1 on every PR. This module gives the codebase *named fault points* —
``FaultPoint("ckpt.write_shard")``, ``FaultPoint("engine.step")``, ... — that
are free when disarmed (one attribute read) and, when armed, fire
deterministically according to a trigger spec:

- **nth**: fire on specific hit numbers (1-based, comma list) — "kill the save
  on the 2nd shard write";
- **p + seed**: fire with fixed-seed probability per hit — reproducible chaos;
- **times**: cap total fires (default 1 — most chaos tests want exactly one
  crash, not a crash loop);
- **action**: ``raise`` (:class:`InjectedFault`), ``delay`` (sleep
  ``delay_s``), or ``partial`` (truncate the file the call site is writing,
  *then* raise — a torn write, not just a missing one).

Arming is programmatic (``FAULTS.arm(...)`` in tests, always through a
``try/finally FAULTS.reset()``) or via the ``PDNLP_TPU_FAULTS`` env var so a
real training job can be chaos-tested without code changes::

    PDNLP_TPU_FAULTS="ckpt.write_shard:nth=2:action=partial;engine.step:p=0.05:seed=7"

Every fault-point name must be registered in :data:`CATALOG` (name → doc);
``tools/check_faults.py`` lints that call sites and catalog agree, and tier-1
enforces it — an undocumented fault point is a typo waiting to disarm a test.

Stdlib-only on purpose: the checkpoint writer, the serving loop, and the lint
tool all import this without pulling in torch.

A copy of ``paddlenlp_tpu/utils/faults.py``.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = [
    "CATALOG",
    "FAULTS",
    "FaultPoint",
    "FaultRegistry",
    "InjectedFault",
]

ENV_VAR = "PDNLP_TPU_FAULTS"

#: Single source of truth for fault-point names. A :class:`FaultPoint` whose
#: name is missing here raises at construction; ``tools/check_faults.py``
#: additionally fails if a catalog entry has no call site or no doc.
CATALOG: Dict[str, str] = {
    "ckpt.write_shard": "After each optimizer/model shard file is written in the "
                        "checkpoint staging dir, before the commit manifest. 'partial' "
                        "truncates the shard mid-file — a torn write.",
    "ckpt.commit": "Immediately before the commit manifest is written and the staging "
                   "dir is renamed into place — a crash here must leave the previous "
                   "committed checkpoint as the resume target.",
    "engine.step": "Top of InferenceEngine.step() — an exception here is what the "
                   "engine-loop supervisor must absorb (degrade, rebuild, requeue).",
    "engine.rebuild": "Inside the supervisor's engine-rebuild attempt — failing it "
                      "extends the DEGRADED window (503 + Retry-After) deterministically.",
    "engine.shard_init": "Top of ShardedBackend.__init__, before the device mesh and "
                         "NamedSharding layouts are built — a failure here makes a "
                         "sharded-engine construction (including the supervisor's "
                         "rebuild of one) fail deterministically: the loop must go "
                         "DEGRADED, retry the rebuild and recover with zero stream "
                         "loss.",
    "engine.prefill_chunk": "Top of the engine's ragged mixed prefill/decode step, "
                            "before the capacity pass and chunk schedule — a crash here leaves "
                            "requests partially prefilled (no token emitted) and must "
                            "triage through the supervisor with token-exact retry and "
                            "no leaked KV blocks.",
    "engine.kv_migrate": "Immediately before the engine dispatches one sequence's "
                         "prefill→decode KV-block migration (disaggregated backend) — "
                         "a failure here hits a request whose first token already "
                         "streamed; the supervisor must degrade, rebuild both stages "
                         "and requeue token-exactly with no block leaked in either "
                         "pool.",
    "serving.submit": "Inside Scheduler.submit after the admission slot is taken — "
                      "exercises the release-on-error path and HTTP 500 mapping.",
    "router.forward": "Immediately before the router opens the upstream connection for "
                      "one forwarding attempt — an injected failure is handled exactly "
                      "like a socket error: candidate excluded, request re-routed or "
                      "failed over to the next replica.",
    "router.health_poll": "Inside the ReplicaPool prober before the /health scrape of "
                          "one replica — injected failures drive the HEALTHY → DEGRADED "
                          "→ DOWN demotion deterministically without killing a server.",
    "router.membership": "Top of a ReplicaPool membership mutation (add / drain / "
                         "remove), before any state changes — a failure here must "
                         "leave the replica set exactly as it was (the admin plane "
                         "returns 5xx, the pool stays consistent, traffic unaffected).",
    "router.provision": "Top of one autoscaler provision attempt, before the "
                        "ReplicaProvisioner starts a new replica — a failure here must "
                        "retry with backoff on later control-loop ticks, never strand a "
                        "tombstoned (force-removed DOWN) replica unreplaced, and never "
                        "leave a half-joined replica in the pool.",
    "sched.shed": "Inside the scheduler's brownout shed path, after the shed decision "
                  "but before the rejection is raised — an injected failure here must "
                  "surface as a clean 500 with no admission-window slot taken and no "
                  "engine-side state.",
    "engine.slot_rebuild": "Inside the supervisor's slot-level quarantine of one "
                           "poisoned request, before its KV blocks are released — a "
                           "failure here escalates to the full engine rebuild path "
                           "(DEGRADED, triage, rebuild) deterministically.",
    "usage.seal": "Inside UsageLedger segment sealing, after the open segment's "
                  "last append but before the atomic rename-commit of the sealed "
                  "file — a crash here must leave a loadable ledger (the open "
                  "segment's torn tail dropped + counted, every sealed byte "
                  "intact). 'partial' truncates the open segment mid-line first: "
                  "the torn-write case the reload tolerance exists for.",
    "engine.adapter_load": "Inside AdapterRegistry.acquire, after the pool-slot "
                           "decision but before the adapter weights land in the "
                           "device pool — the failure carries the acquiring "
                           "request's req_id so the supervisor quarantines ONLY "
                           "that tenant's request (engine_error / token-exact "
                           "retry); other tenants' streams must be uninterrupted "
                           "and no adapter slot or KV block may leak.",
    "engine.weight_load": "Inside the /admin/weights handler, before the committed "
                          "checkpoint is validated and loaded — a failure here must "
                          "map to a clean HTTP error with ZERO engine-side mutation "
                          "(no params touched, no cache epoch bumped, the loop "
                          "keeps serving under the old weights).",
    "engine.weight_swap": "Inside the engine loop's quiesced swap execution, after "
                          "the old params are retained but before sync_params "
                          "installs the new tree — a failure here must roll the "
                          "replica back to the retained old weights (cache epoch "
                          "re-bumped, canary skipped) with zero stream loss and "
                          "no param-buffer or KV-block leak.",
    "router.rollout": "Top of one per-replica rollout step (drain → swap → rejoin) "
                      "in the router's fleet weight rollout, before the drain is "
                      "initiated — a failure here must abort the whole rollout, "
                      "roll already-swapped replicas back to the old version, "
                      "undrain everything and leave the fleet serving on the old "
                      "weights with zero client-visible errors.",
    "engine.kv_spill": "Inside the engine's spill drain, before the batched D2H "
                       "gather of LRU-evicted prefix blocks into the host KV tier — "
                       "a failure here must simply drop the spill (the blocks were "
                       "already recycled; pre-tier behavior) with no host- or "
                       "device-tier entry leaked and every live stream unaffected.",
    "engine.kv_promote": "Immediately before the engine dispatches a host→device "
                         "KV promotion for an admitted request whose prefix "
                         "matched host-tier blocks — a failure here must fall "
                         "back token-exactly to a cold re-prefill of the promoted "
                         "span (the request keeps its allocated blocks, prefill "
                         "recomputes them), with zero stream loss and no host- or "
                         "device-tier block leak.",
}


class InjectedFault(RuntimeError):
    """Raised by an armed fault point. Deliberately an *ordinary* exception:
    recovery code must treat it exactly like a real ValueError/OSError from
    the same call site."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


@dataclasses.dataclass
class TriggerSpec:
    """How an armed fault point decides to fire (see module docstring)."""

    action: str = "raise"  # raise | delay | partial
    nth: Optional[Tuple[int, ...]] = None  # 1-based hit numbers; None = every hit
    p: Optional[float] = None  # per-hit fire probability (with fixed seed)
    seed: int = 0
    times: Optional[int] = 1  # max total fires; None = unlimited
    delay_s: float = 0.05

    def __post_init__(self):
        if self.action not in ("raise", "delay", "partial"):
            raise ValueError(f"fault action must be raise/delay/partial, got {self.action!r}")
        if self.nth is not None and self.p is not None:
            raise ValueError("trigger spec takes nth= OR p=, not both")


def _parse_spec(text: str) -> Tuple[str, TriggerSpec]:
    """``"name:key=val:key=val"`` → (name, TriggerSpec). Used for env arming."""
    parts = [p for p in text.strip().split(":") if p]
    if not parts:
        raise ValueError("empty fault spec")
    name, kw = parts[0], {}
    for part in parts[1:]:
        if "=" not in part:
            raise ValueError(f"fault spec field {part!r} is not key=value")
        k, v = part.split("=", 1)
        if k == "nth":
            kw["nth"] = tuple(int(x) for x in v.split(","))
        elif k == "p":
            kw["p"] = float(v)
        elif k in ("seed", "times"):
            kw[k] = int(v)
        elif k == "delay_s":
            kw["delay_s"] = float(v)
        elif k == "action":
            kw["action"] = v
        else:
            raise ValueError(f"unknown fault spec field {k!r}")
    return name, TriggerSpec(**kw)


class FaultRegistry:
    """Process-wide armed-fault state. Thread-safe; the disarmed fast path is
    a single attribute read so fault points can sit on hot paths."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[str, TriggerSpec] = {}
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._enabled = False  # lock-free fast-path flag
        self._env_loaded = False

    # ----------------------------------------------------------------- arming
    def arm(self, name: str, action: str = "raise", nth=None, p: Optional[float] = None,
            seed: int = 0, times: Optional[int] = 1, delay_s: float = 0.05) -> TriggerSpec:
        """Arm ``name`` with a trigger spec (replaces any existing spec and
        resets its hit/fire counters). ``nth`` may be an int or an iterable."""
        if name not in CATALOG:
            raise ValueError(f"unknown fault point {name!r}; register it in faults.CATALOG")
        if isinstance(nth, int):
            nth = (nth,)
        elif nth is not None:
            nth = tuple(int(x) for x in nth)
        spec = TriggerSpec(action=action, nth=nth, p=p, seed=seed, times=times, delay_s=delay_s)
        with self._lock:
            self._armed[name] = spec
            self._hits[name] = 0
            self._fired[name] = 0
            self._rngs[name] = random.Random(seed)
            self._enabled = True
        return spec

    def arm_from_spec(self, text: str):
        """Arm from a ``;``-separated spec string (the ``PDNLP_TPU_FAULTS`` format)."""
        for chunk in text.split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            name, spec = _parse_spec(chunk)
            self.arm(name, action=spec.action, nth=spec.nth, p=spec.p, seed=spec.seed,
                     times=spec.times, delay_s=spec.delay_s)

    def load_env(self, force: bool = False):
        """Arm from ``PDNLP_TPU_FAULTS`` once per process (idempotent)."""
        with self._lock:
            if self._env_loaded and not force:
                return
            self._env_loaded = True
        text = os.environ.get(ENV_VAR, "")
        if text:
            self.arm_from_spec(text)

    def disarm(self, name: Optional[str] = None):
        """Disarm one point (or all with ``name=None``); counters survive."""
        with self._lock:
            if name is None:
                self._armed.clear()
            else:
                self._armed.pop(name, None)
            self._enabled = bool(self._armed)

    def reset(self):
        """Disarm everything and clear counters — every test's ``finally``."""
        with self._lock:
            self._armed.clear()
            self._hits.clear()
            self._fired.clear()
            self._rngs.clear()
            self._enabled = False

    # ----------------------------------------------------------------- state
    def armed(self, name: str) -> Optional[TriggerSpec]:
        with self._lock:
            return self._armed.get(name)

    def hits(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)

    def fired(self, name: str) -> int:
        with self._lock:
            return self._fired.get(name, 0)

    # ----------------------------------------------------------------- firing
    def fire(self, name: str, file: Optional[str] = None, **ctx):
        """One hit of fault point ``name``. No-op unless armed and the trigger
        spec selects this hit. ``file`` names the file the call site is mid-way
        through writing — the ``partial`` action truncates it before raising."""
        if not self._enabled:
            return
        with self._lock:
            spec = self._armed.get(name)
            if spec is None:
                return
            self._hits[name] = hit = self._hits.get(name, 0) + 1
            if spec.times is not None and self._fired.get(name, 0) >= spec.times:
                return
            if spec.nth is not None:
                should = hit in spec.nth
            elif spec.p is not None:
                should = self._rngs[name].random() < spec.p
            else:
                should = True
            if not should:
                return
            self._fired[name] = self._fired.get(name, 0) + 1
            action, delay_s = spec.action, spec.delay_s
        # act outside the lock: sleeping or truncating under it would serialize
        # unrelated fault points
        if action == "delay":
            time.sleep(delay_s)
            return
        if action == "partial" and file is not None and os.path.isfile(file):
            size = os.path.getsize(file)
            with open(file, "r+b") as f:
                f.truncate(size // 2)
        raise InjectedFault(name, hit)


#: process-wide registry (env-armed lazily on first FaultPoint fire)
FAULTS = FaultRegistry()


class FaultPoint:
    """A named place where a fault can be injected.

    Declare once at module level (``_F_STEP = FaultPoint("engine.step")``) and
    call ``.fire(**ctx)`` on the hot path — the disarmed cost is one attribute
    read plus a method call. Construction validates the name against
    :data:`CATALOG` so typos fail at import, not silently never-fire."""

    __slots__ = ("name", "_registry")

    def __init__(self, name: str, registry: Optional[FaultRegistry] = None):
        if name not in CATALOG:
            raise ValueError(f"unknown fault point {name!r}; register it in faults.CATALOG")
        self.name = name
        self._registry = registry or FAULTS

    def fire(self, file: Optional[str] = None, **ctx):
        r = self._registry
        if not r._env_loaded:
            r.load_env()
        if r._enabled:
            r.fire(self.name, file=file, **ctx)

    def __repr__(self):
        return f"FaultPoint({self.name!r})"
