"""Multi-tenant serving: per-tenant isolation and usage metering.

- :mod:`.quotas` — :class:`TenantQuotas`: per-tenant admission limits (max
  inflight, KV-block share) that ride the priority classes, plus the
  per-tenant goodput fold over the engine's request-attributed token
  accounting.
- :mod:`.metering` — :class:`UsageMeter`: billing-grade usage records (one
  per finished request, trace-id idempotent) with a rolling per-tenant/
  per-adapter aggregate and an optional durable JSONL ledger
  (``observability/usage.py``) whose totals reconcile against the goodput
  ledger's useful-token truth.
- :mod:`.adapters` — the adapter errors and dimensions only; the
  ``AdapterRegistry`` (batched multi-LoRA) is ROADMAP Queue 1 item 10.

Copies of ``paddlenlp_tpu/serving/tenancy/``.
"""

from .adapters import AdapterPressure, PROJ_NAMES, UnknownAdapterError, adapter_dims_from_config
from .metering import UsageMeter
from .quotas import (DEFAULT_TENANT, TenantQuota, TenantQuotas,
                     tenant_goodput_fold)

__all__ = [
    "UsageMeter",
    "AdapterPressure",
    "UnknownAdapterError",
    "adapter_dims_from_config",
    "PROJ_NAMES",
    "DEFAULT_TENANT",
    "TenantQuota",
    "TenantQuotas",
    "tenant_goodput_fold",
]
