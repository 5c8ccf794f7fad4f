"""Multi-tenant serving: batched multi-LoRA adapters, per-tenant isolation and
usage metering.

- :mod:`.adapters` — the :class:`AdapterRegistry`: a content-addressed host
  store of LoRA A/B weight pairs plus a fixed-size adapter pool with refcount
  + LRU eviction (``paged_cache.BlockManager``'s block discipline applied to
  adapter slots). The engine acquires a pool slot per admitted request and
  the backend gathers per-row deltas from the pool's device copy.
- :mod:`.quotas` — :class:`TenantQuotas`: per-tenant admission limits (max
  inflight, KV-block share) that ride the priority classes, plus the
  per-tenant goodput fold over the engine's request-attributed token
  accounting.
- :mod:`.metering` — :class:`UsageMeter`: billing-grade usage records (one
  per finished request, trace-id idempotent) with a rolling per-tenant/
  per-adapter aggregate and an optional durable JSONL ledger
  (``observability/usage.py``) whose totals reconcile against the goodput
  ledger's useful-token truth.

Copies of ``paddlenlp_tpu/serving/tenancy/``.
"""

from .adapters import AdapterPressure, AdapterRegistry, PROJ_NAMES, UnknownAdapterError, adapter_dims_from_config
from .metering import UsageMeter
from .quotas import (DEFAULT_TENANT, TenantQuota, TenantQuotas,
                     tenant_goodput_fold)

__all__ = [
    "UsageMeter",
    "AdapterPressure",
    "AdapterRegistry",
    "UnknownAdapterError",
    "adapter_dims_from_config",
    "PROJ_NAMES",
    "DEFAULT_TENANT",
    "TenantQuota",
    "TenantQuotas",
    "tenant_goodput_fold",
]
