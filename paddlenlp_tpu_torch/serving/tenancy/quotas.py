"""Per-tenant admission quotas + the per-tenant goodput fold.

A tenant is a client-declared string on every request (``"default"`` when
absent). Isolation has three legs, each riding machinery that already
exists:

- **max inflight** — the scheduler's admission window, partitioned: a tenant
  at its cap sheds with ``reason="tenant_quota"`` (HTTP 503) while other
  tenants admit normally. Rides the priority classes: the quota check runs
  AFTER brownout, so a browned-out class sheds as before regardless of quota
  headroom.
- **KV-block share** — an engine-side admission gate: a tenant whose running
  requests already hold its share of the usable KV blocks waits in queue
  (the ``kv_pressure`` gate pattern), it is not errored. Prevents one tenant
  with long prompts from starving the pool.
- **goodput fold** — the engine attributes useful/rework token positions per
  request (it already computes them per request for the goodput ledger); this
  module folds those per-tenant counters into the ``stats()`` /
  ``/debug/efficiency`` document.

:class:`TenantQuotas` is pure policy (no locks, no counters): callers own
their bookkeeping — the scheduler its inflight map, the engine its per-tenant
block counts — and ask this object only for the limits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["DEFAULT_TENANT", "TenantQuota", "TenantQuotas", "tenant_goodput_fold"]

#: the tenant every request without an explicit ``tenant`` field belongs to
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Limits for one tenant; ``None`` means unlimited."""

    max_inflight: Optional[int] = None
    kv_block_share: Optional[float] = None  # fraction of usable KV blocks, 0..1

    def __post_init__(self):
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1 (or None for unlimited)")
        if self.kv_block_share is not None \
                and not (0.0 < self.kv_block_share <= 1.0):
            raise ValueError("kv_block_share must be in (0, 1] (or None)")


class TenantQuotas:
    """Per-tenant limits with a default for unlisted tenants.

    ``quotas`` maps tenant -> :class:`TenantQuota` (or a plain dict with the
    same fields); ``default`` applies to tenants without an entry — the
    usual fleet shape is one generous default plus explicit caps for the
    noisy tenants."""

    def __init__(self, quotas: Optional[Dict[str, object]] = None,
                 default: Optional[object] = None):
        self._quotas = {t: self._coerce(q) for t, q in (quotas or {}).items()}
        self._default = self._coerce(default) if default is not None \
            else TenantQuota()

    @staticmethod
    def _coerce(q) -> TenantQuota:
        if isinstance(q, TenantQuota):
            return q
        if isinstance(q, dict):
            return TenantQuota(**q)
        raise TypeError(f"tenant quota must be TenantQuota or dict, "
                        f"got {type(q).__name__}")

    def quota(self, tenant: str) -> TenantQuota:
        return self._quotas.get(tenant, self._default)

    def max_inflight(self, tenant: str) -> Optional[int]:
        return self.quota(tenant).max_inflight

    def kv_block_cap(self, tenant: str, total_usable_blocks: int) -> Optional[int]:
        """Absolute block cap for ``tenant`` (None = uncapped), floored at 1
        so a tiny share can never make a tenant unadmittable outright."""
        share = self.quota(tenant).kv_block_share
        if share is None:
            return None
        return max(1, int(share * total_usable_blocks))

    def describe(self) -> Dict:
        return {
            "default": dataclasses.asdict(self._default),
            "tenants": {t: dataclasses.asdict(q) for t, q in sorted(self._quotas.items())},
        }


def tenant_goodput_fold(tenant_counts: Dict[str, Dict[str, int]]) -> Dict[str, Dict]:
    """Fold the engine's per-tenant token attribution into per-tenant goodput.

    ``tenant_counts`` is ``{tenant: {"useful": n, "rework": n, "requests": n,
    "tokens_out": n}}`` (the engine's ``tenant_goodput`` accumulator). The
    per-tenant ratio is ``useful / (useful + rework)`` — padding and
    speculative rejection are step-global costs that cannot be attributed to
    one tenant's rows, so the fold deliberately covers only the attributable
    part of the goodput ledger's conservation invariant."""
    out: Dict[str, Dict] = {}
    for tenant, c in sorted(tenant_counts.items()):
        useful = int(c.get("useful", 0))
        rework = int(c.get("rework", 0))
        attributed = useful + rework
        out[tenant] = {
            "useful": useful,
            "rework": rework,
            "requests": int(c.get("requests", 0)),
            "tokens_out": int(c.get("tokens_out", 0)),
            "goodput_ratio": round(useful / attributed, 6) if attributed else 1.0,
        }
    return out
