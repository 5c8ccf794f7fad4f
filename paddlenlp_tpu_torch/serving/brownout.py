"""Overload brownout: graceful degradation when scaling can't keep up.

When the autoscaler is at its max envelope (or a provision is still in
flight), a saturated replica must degrade *selectively* instead of timing out
uniformly: an interactive user keeps a fast first token while a best-effort
batch job gets a clean 503 + ``Retry-After``. The :class:`BrownoutController`
owns that ladder — a small state machine the :class:`~.scheduler.Scheduler`
consults on every admission:

====== ================== ==========================================================
level  name               effect
====== ================== ==========================================================
0      ``normal``         nothing
1      ``shed_best_effort`` ``priority="best_effort"`` submissions 503 on arrival
2      ``conserve``       + speculative decode disabled on the engine, and the
                          replica advertises ``brownout>=2`` on ``/health`` so the
                          router stops racing hedge shadows against it
3      ``clamp``          + ``max_new_tokens`` of newly admitted requests capped
====== ================== ==========================================================

**Entry** is driven by a pressure signal (the scheduler wires
``max(inflight / max_inflight, queue_wait_estimate / saturation_wait_s)``) or
by an external *push* (the router's SLO fast-burn hook or the autoscaler at
its max envelope POST ``/admin/brownout`` — the same best-effort propagation
channel drains use). A push sets a level *floor* with a TTL; local pressure
can escalate above it but never below while it holds.

**Exit** is hysteresis-guarded: pressure must stay below ``exit_pressure``
continuously for ``exit_hold_s`` before the ladder steps DOWN one level —
and the clock restarts per level, so a flapping signal cannot oscillate the
fleet between shedding and not shedding. Escalations are likewise spaced by
``step_hold_s`` so one pressure spike cannot jump straight to clamping.

Every level change is a cataloged flight-recorder event
(``brownout.enter``/``brownout.step``/``brownout.exit``) — the postmortem
trail shows exactly when and why the replica started shedding.

**Concurrency model.** ``evaluate``/``push``/``note_level`` may be called
from any HTTP worker thread (the scheduler evaluates on every submit, the
admin plane pushes); all mutable state is guarded by ``_lock`` (``#
guarded-by:`` annotations, enforced by the ``tools/analyze`` lock-discipline
checker). Level transitions are decided AND applied under a dedicated
``_apply_lock`` (held across both, with ``_lock`` only for the state
mutation inside) so a concurrent evaluate/push pair cannot apply enter and
exit side effects in the opposite order from the decisions; the
``on_level_change`` hook runs under ``_apply_lock`` but outside ``_lock``
(it touches the engine).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from ..observability.flight_recorder import RECORDER
from ..observability.tracer import TRACER
from ..utils.log import logger

__all__ = ["BrownoutController", "BrownoutPolicy", "PRIORITIES",
           "BROWNOUT_LEVELS"]

#: the request-priority vocabulary, most- to least-protected. ``interactive``
#: is the default for requests that don't say.
PRIORITIES = ("interactive", "batch", "best_effort")

#: ladder level names, index == level
BROWNOUT_LEVELS = ("normal", "shed_best_effort", "conserve", "clamp")


@dataclasses.dataclass
class BrownoutPolicy:
    """Knobs governing the ladder. ``enter_pressure``/``exit_pressure`` bound
    the hysteresis band; ``saturation_wait_s`` is the queue-wait estimate that
    counts as pressure 1.0 (the scheduler folds it into the signal);
    ``step_hold_s`` spaces escalations, ``exit_hold_s`` is the sustained-calm
    requirement per de-escalation step; ``max_tokens_cap`` is the level-3
    clamp; ``push_ttl_s`` is how long a router/autoscaler push floors the
    level without being refreshed."""

    enter_pressure: float = 1.0
    exit_pressure: float = 0.5
    saturation_wait_s: float = 1.0
    step_hold_s: float = 2.0
    exit_hold_s: float = 5.0
    max_level: int = 3
    max_tokens_cap: int = 32
    push_ttl_s: float = 30.0

    def __post_init__(self):
        if not 0 <= self.exit_pressure <= self.enter_pressure:
            raise ValueError(
                f"need 0 <= exit_pressure <= enter_pressure, got "
                f"{self.exit_pressure} / {self.enter_pressure}")
        if not 0 <= self.max_level < len(BROWNOUT_LEVELS):
            raise ValueError(f"max_level must be in [0, {len(BROWNOUT_LEVELS) - 1}]")
        if self.max_tokens_cap < 1:
            raise ValueError("max_tokens_cap must be >= 1")


class BrownoutController:
    """The replica-side overload ladder (see module docstring).

    ``pressure_fn`` returns the current saturation signal (>= 1.0 means
    overloaded); ``on_level_change(level)`` applies level side effects (the
    serving server wires spec-decode disable here). ``now`` is injectable on
    every method so tests drive synthetic timelines."""

    def __init__(self, policy: Optional[BrownoutPolicy] = None,
                 pressure_fn: Optional[Callable[[], float]] = None,
                 on_level_change: Optional[Callable[[int], None]] = None):
        self.policy = policy or BrownoutPolicy()
        self.pressure_fn = pressure_fn
        self.on_level_change = on_level_change
        self._lock = threading.Lock()
        self._level = 0  # guarded-by: _lock
        self._pushed_level = 0  # guarded-by: _lock — external floor
        self._pushed_until = 0.0  # guarded-by: _lock — floor expiry
        # the last level _note_transition reported: evaluate()/push() diff
        # against THIS (not the instantaneous effective level) so a floor
        # expiring via TTL between calls still fires the exit transition —
        # otherwise on_level_change side effects (spec decode off) would
        # outlive the brownout silently
        self._last_reported = 0  # guarded-by: _lock
        self._last_step_t = 0.0  # guarded-by: _lock — last escalation time
        self._calm_since: Optional[float] = None  # guarded-by: _lock — exit-hysteresis anchor
        self._entered_t = 0.0  # guarded-by: _lock — when level left 0
        # level transitions are DECIDED and applied (hook + event) atomically
        # under this lock so a concurrent evaluate/push pair cannot apply
        # enter and exit in the opposite order from the decisions
        self._apply_lock = threading.Lock()
        # monotone counters for stats()/bench (single-writer-ish int bumps,
        # read-only consumers tolerate a momentarily stale value)
        self.entries = 0
        self.sheds = 0

    # ------------------------------------------------------------- inspection
    @property
    def level(self) -> int:
        with self._lock:
            return self._effective_level(time.time())

    @property
    def level_name(self) -> str:
        return BROWNOUT_LEVELS[self.level]

    def _effective_level(self, now: float) -> int:  # holds-lock: _lock
        """Caller holds ``_lock``. The local ladder level, floored by an
        unexpired push."""
        floor = self._pushed_level if now < self._pushed_until else 0
        return max(self._level, floor)

    # ------------------------------------------------------------- decisions
    def should_shed(self, priority: str, now: Optional[float] = None) -> bool:
        """True when this submission must be rejected on arrival: level >= 1
        sheds ``best_effort`` traffic first (the bottom of the ladder)."""
        if priority != "best_effort":
            return False
        now = now if now is not None else time.time()
        with self._lock:
            shed = self._effective_level(now) >= 1
            if shed:
                self.sheds += 1
        return shed

    def max_tokens_cap(self, now: Optional[float] = None) -> Optional[int]:
        """The level-3 clamp on ``max_new_tokens`` for NEW requests (None =
        no clamp)."""
        now = now if now is not None else time.time()
        with self._lock:
            return self.policy.max_tokens_cap if self._effective_level(now) >= 3 else None

    def spec_disabled(self, now: Optional[float] = None) -> bool:
        """Level >= 2: speculative decode should be off (it spends device
        cycles on throughput the fleet does not have)."""
        now = now if now is not None else time.time()
        with self._lock:
            return self._effective_level(now) >= 2

    # ------------------------------------------------------------- transitions
    def evaluate(self, now: Optional[float] = None) -> int:
        """Fold one pressure reading into the ladder; returns the effective
        level. Safe (and cheap) to call on every admission."""
        if self.pressure_fn is None:
            return self.level
        now = now if now is not None else time.time()
        try:
            pressure = float(self.pressure_fn())
        except Exception as e:  # a broken signal must never take down admission
            logger.warning(f"brownout: pressure signal failed: {e!r}")
            return self.level
        with self._apply_lock:
            with self._lock:
                before = self._last_reported
                if pressure >= self.policy.enter_pressure:
                    self._calm_since = None
                    if (self._level < self.policy.max_level
                            and now - self._last_step_t >= self.policy.step_hold_s):
                        self._level += 1
                        self._last_step_t = now
                elif pressure < self.policy.exit_pressure and self._level > 0:
                    if self._calm_since is None:
                        self._calm_since = now
                    elif now - self._calm_since >= self.policy.exit_hold_s:
                        self._level -= 1
                        # hysteresis restarts per level: each step down needs
                        # its own sustained-calm window
                        self._calm_since = now
                else:
                    # inside the hysteresis band: neither escalate nor start/
                    # keep the calm clock — the ladder holds
                    self._calm_since = None
                after = self._effective_level(now)
                self._last_reported = after
            self._note_transition(before, after, "saturation", now)
        return after

    def push(self, level: int, reason: str = "slo_fast_burn",
             ttl_s: Optional[float] = None, now: Optional[float] = None) -> int:
        """External brownout floor (router SLO fast burn / autoscaler at its
        max envelope). Repeated pushes refresh the TTL; ``level=0`` lifts the
        floor immediately (local pressure still governs the local ladder)."""
        level = max(0, min(int(level), self.policy.max_level))
        now = now if now is not None else time.time()
        ttl = float(ttl_s) if ttl_s is not None else self.policy.push_ttl_s
        with self._apply_lock:
            with self._lock:
                before = self._last_reported
                self._pushed_level = level
                self._pushed_until = now + ttl if level > 0 else 0.0
                after = self._effective_level(now)
                self._last_reported = after
            self._note_transition(before, after, reason, now)
        return after

    def _note_transition(self, before: int, after: int, reason: str, now: float):
        """Record one effective-level transition (hook + flight-recorder event
        + span instant). Caller holds ``_apply_lock`` (and NOT ``_lock``):
        decision and application are atomic with respect to each other, so a
        concurrent evaluate/push pair cannot apply enter and exit in the
        opposite order from the transitions they decided."""
        if after == before:
            return
        if before == 0 and after > 0:
            with self._lock:
                self._entered_t = now
            self.entries += 1
            RECORDER.record(
                "brownout.enter", reason=reason if reason in
                ("saturation", "slo_fast_burn") else "slo_fast_burn",
                level=after)
        elif before > 0 and after == 0:
            with self._lock:
                held = now - self._entered_t
            RECORDER.record("brownout.exit", held_s=round(held, 3))
        else:
            RECORDER.record("brownout.step", prev=before, level=after,
                            direction="up" if after > before else "down")
        TRACER.instant("brownout", cat="scheduler", prev=before, level=after,
                       reason=reason)
        logger.warning(
            f"brownout: {BROWNOUT_LEVELS[before]} -> {BROWNOUT_LEVELS[after]} "
            f"({reason})")
        if self.on_level_change is not None:
            try:
                self.on_level_change(after)
            except Exception as e:
                logger.warning(f"brownout: level-change hook failed: {e!r}")

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            now = time.time()
            eff = self._effective_level(now)
            return {
                "level": eff,
                "level_name": BROWNOUT_LEVELS[eff],
                "local_level": self._level,
                "pushed_level": self._pushed_level if now < self._pushed_until else 0,
                "entries": self.entries,
                "sheds": self.sheds,
            }
