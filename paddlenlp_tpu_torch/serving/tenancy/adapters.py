"""Multi-LoRA adapter surface of the serving tier.

Part of ``paddlenlp_tpu/serving/tenancy/adapters.py``: the two errors the
engine, the loop and the HTTP API raise and catch, and the per-projection
dimensions ``/admin/weights`` checks a checkpoint against. The
``AdapterRegistry`` itself (host store, device pool, per-row LoRA deltas) is
not part of the port yet (ROADMAP Queue 1 item 10): an engine without a
registry refuses every ``adapter_id``.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["AdapterPressure", "UnknownAdapterError", "adapter_dims_from_config", "PROJ_NAMES"]

#: the projections a LoRA adapter may target, in canonical order — the same
#: seven matmuls the serving forward applies per layer
PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj")


class AdapterPressure(RuntimeError):
    """Every pool slot is held by an in-use adapter: the acquire must wait.

    The engine treats this exactly like KV-block pressure — the request stays
    queued and re-tries admission next step; it is NOT an error surfaced to
    the client."""


class UnknownAdapterError(ValueError):
    """``adapter_id`` names no adapter in the host store."""


def adapter_dims_from_config(config) -> Dict[str, Tuple[int, int]]:
    """Per-projection (d_in, d_out) from a model config — the shapes the pool
    arrays must carry for each targetable matmul."""
    h = int(config.hidden_size)
    n_heads = int(config.num_attention_heads)
    n_kv = int(getattr(config, "num_key_value_heads", n_heads) or n_heads)
    head_dim = int(getattr(config, "head_dim", h // n_heads))
    inter = int(getattr(config, "intermediate_size", 4 * h))
    q = n_heads * head_dim
    kv = n_kv * head_dim
    return {
        "q_proj": (h, q),
        "k_proj": (h, kv),
        "v_proj": (h, kv),
        "o_proj": (q, h),
        "gate_proj": (h, inter),
        "up_proj": (h, inter),
        "down_proj": (inter, h),
    }
