"""AdamW with optax's semantics over a flat ``{name: tensor}`` dict.

The optimizer of the JAX trainer (``paddlenlp_tpu/trainer/trainer.py``
:125-170) is ``optax.chain(clip_by_global_norm(max_grad_norm),
adamw(schedule, b1, b2, eps, weight_decay, mask))``. Its semantics, which
differ from ``torch.optim.AdamW``: ``clip_by_global_norm`` scales by
``max_norm / g_norm`` only when ``g_norm >= max_norm``; AdamW keeps ``eps``
outside the square root, decays every leaf except biases, norms and scales
(:138-148), and update k (counting from 0) takes ``schedule(k)``.

:meth:`AdamW.state_dict` names the state by the optax chain's leaf paths, as
the unified checkpoint stores it (``<chain>/0/count``, ``<chain>/0/mu/<param>``,
``<chain>/0/nu/<param>``, ``<chain>/2/count``; ``<chain>`` is 1 behind the
clip, 0 without it), so a checkpoint of either package resumes in the other.
Under a PEFT mask (``masked=True``: ``params`` holds the trainable leaves
only) the JAX chain sits inside ``optax.multi_transform``'s ``"train"``
transform, so ``inner_states/train/inner_state/`` heads every path; the
frozen leaves have no state.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from ...utils.log import logger

__all__ = ["AdamW", "global_norm"]


def _decays(name: str) -> bool:
    """The JAX trainer's weight-decay mask (:138-148)."""
    return not (name.endswith("bias") or "norm" in name.lower() or name.endswith("scale"))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1, b2,
    eps, weight_decay, mask))`` over a flat ``{name: tensor}`` dict, updated in
    place. The moments live beside the parameters, in fp32. ``decays(name)``
    is the weight-decay mask (default: the JAX trainer's). ``schedule`` is a
    function of the update count or a constant learning rate."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Union[Callable[[int], float], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 0.0, decays: Callable[[str], bool] = _decays, masked: bool = False):
        self.schedule = schedule if callable(schedule) else (lambda count, lr=float(schedule): lr)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decays = decays
        self.max_grad_norm = max_grad_norm
        self.state_prefix = "inner_states/train/inner_state/" if masked else ""
        self.mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        self.count = 0  # updates applied so far (optax's shared step count)

    def lr_scale(self, name: str) -> float:
        """Factor on the learning rate of parameter ``name`` (1 here)."""
        return 1.0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             g_norm: Optional[torch.Tensor] = None):
        clip = None
        if self.max_grad_norm and self.max_grad_norm > 0:
            g_norm = global_norm(grads.values()) if g_norm is None else g_norm
            keep = g_norm < self.max_grad_norm

            def clip(g):
                return torch.where(keep, g, g / g_norm * self.max_grad_norm)

        lr = float(self.schedule(self.count))
        self.count += 1
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        # one leaf's temporaries at a time (its clipped gradient, the update):
        # the arithmetic of optax's chain, in its order
        for k, p in params.items():
            g = (grads[k] if clip is None else clip(grads[k])).float()
            mu, nu = self.mu[k], self.nu[k]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g.square(), alpha=1.0 - self.b2)
            del g
            update = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(self.eps))
            if self.weight_decay > 0 and self.decays(k):
                update = update + self.weight_decay * p
            p.add_(update.to(p.dtype), alpha=-lr * self.lr_scale(k))

    # ------------------------------------------------------------------ state (optax leaf paths)
    @property
    def _chain(self) -> str:
        return self.state_prefix + ("1" if self.max_grad_norm and self.max_grad_norm > 0 else "0")

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The optax state's leaves by path, in ``jax.tree_util``'s order (the
        live moment tensors, not copies; the counts as int32 scalars)."""
        chain = self._chain
        count = torch.tensor(self.count, dtype=torch.int32)
        names = sorted(self.mu, key=lambda k: k.split("/"))  # jax flattens dicts by sorted key
        out: Dict[str, torch.Tensor] = {f"{chain}/0/count": count}
        out.update({f"{chain}/0/mu/{k}": self.mu[k] for k in names})
        out.update({f"{chain}/0/nu/{k}": self.nu[k] for k in names})
        out[f"{chain}/2/count"] = count.clone()
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]):
        """Restore from :meth:`state_dict`'s keys (values on any device): the
        moments are copied into place and the count drives the bias
        correction and the schedule. A missing moment keeps its fresh value,
        with a warning, as the JAX loader does."""
        chain = self._chain
        counts = {int(state[k]) for k in (f"{chain}/0/count", f"{chain}/2/count") if k in state}
        if len(counts) > 1:
            raise ValueError(f"optimizer state: adam count and schedule count differ ({sorted(counts)})")
        for moment, table in (("mu", self.mu), ("nu", self.nu)):
            for name, t in table.items():
                key = f"{chain}/0/{moment}/{name}"
                if key in state:
                    t.copy_(state[key])
                else:
                    logger.warning(f"optimizer leaf {key} missing in checkpoint; keeping fresh init")
        if counts:
            self.count = counts.pop()
