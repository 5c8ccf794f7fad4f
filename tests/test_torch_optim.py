"""The port's optimizers and fused loss against the JAX package's.

- ``adamwdl`` (layer-wise lr decay, the scanned stack at the mean scale) and
  ``ema`` over 3 steps of the same gradients on the same parameter tree (the
  scanned layout's paths, unrolled ``layers_<i>`` paths too): parameters
  within atol 1e-6 (fp32; the two compute the same update in another order
  of operations), the EMA shadow within atol 1e-6 (a few fp32 ulps: XLA
  fuses the update into fused multiply-adds).
- ``fused_linear_cross_entropy``: the loss and both gradients against
  ``jax.value_and_grad`` of the JAX op, with T = 37 not a multiple of
  ``chunk`` = 8 and ``ignore_index`` rows, at fp32: atol 1e-6 for the loss,
  1e-6 of the largest element for each gradient; ``n_valid`` exact.
- ``fused_linear_cross_entropy`` at bf16, where the port departs from the
  JAX op on purpose: it takes each chunk's weight gradient in fp32, the JAX
  op rounds it to bf16 a chunk. Over 16 chunks the port's weight gradient
  stays within the bf16 gate ``2**-7 |want| + 1e-3 max |want|`` of the
  full-logits gradient (0.54 of it) and is nearer the fp32 gradient than the
  JAX op's, which falls outside that gate (1.76 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlenlp_tpu.ops.cross_entropy import fused_linear_cross_entropy as jax_fused_ce
from paddlenlp_tpu.ops.optimizer import ExponentialMovingAverage as JaxEMA
from paddlenlp_tpu.ops.optimizer import adamwdl as jax_adamwdl
from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss, fused_linear_cross_entropy
from paddlenlp_tpu_torch.ops.optimizer import ExponentialMovingAverage, adamwdl
from paddlenlp_tpu_torch.ops.optimizer.adamwdl import layerwise_lr_decay_mask
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, unflatten_params

SHAPES = {"model/embed_tokens/embedding": (16, 8), "model/layers/self_attn/q_proj/kernel": (3, 8, 8),
          "model/layers/input_layernorm/scale": (3, 8), "model/layers_1/mlp/up_proj/kernel": (8, 12),
          "model/norm/scale": (8,), "lm_head/kernel": (8, 16)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def test_layer_depths_follow_the_jax_labels():
    from paddlenlp_tpu.ops.optimizer import layerwise_lr_decay_mask as jax_mask

    want = flatten_params(jax_mask(unflatten_params(_tree(0)), 3))
    assert layerwise_lr_decay_mask(_tree(0), 3) == want == {
        "model/embed_tokens/embedding": "-1", "model/layers/self_attn/q_proj/kernel": "-2",
        "model/layers/input_layernorm/scale": "-2", "model/layers_1/mlp/up_proj/kernel": "1",
        "model/norm/scale": "3", "lm_head/kernel": "3"}


@pytest.mark.parametrize("schedule", ["constant", "warmup"])
def test_adamwdl_matches_optax(schedule):
    lr = 1e-2 if schedule == "constant" else optax.linear_schedule(0.0, 1e-2, 2)
    port_lr = 1e-2 if schedule == "constant" else (lambda count: 1e-2 * min(count, 2) / 2)
    tx = jax_adamwdl(lr, n_layers=3, layerwise_decay=0.7, weight_decay=0.05)
    jparams = unflatten_params({k: jnp.asarray(v) for k, v in _tree(0).items()})
    jstate = tx.init(jparams)
    params = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    opt = adamwdl(params, port_lr, n_layers=3, layerwise_decay=0.7, weight_decay=0.05)
    for step in range(3):
        grads = _tree(10 + step, scale=0.1)
        updates, jstate = tx.update(unflatten_params({k: jnp.asarray(v) for k, v in grads.items()}), jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(params, {k: torch.from_numpy(v) for k, v in grads.items()})
    for path, want in flatten_params(jax.device_get(jparams)).items():
        np.testing.assert_allclose(params[path].numpy(), np.asarray(want), atol=1e-6, rtol=0, err_msg=path)


@pytest.mark.parametrize("debias", [True, False])
def test_ema_matches_jax(debias):
    jema = JaxEMA(unflatten_params({k: jnp.asarray(v) for k, v in _tree(0).items()}), decay=0.9, debias=debias)
    ema = ExponentialMovingAverage(unflatten_params({k: torch.from_numpy(v) for k, v in _tree(0).items()}),
                                   decay=0.9, debias=debias)
    for step in range(3):
        new = _tree(20 + step)
        jema.update(unflatten_params({k: jnp.asarray(v) for k, v in new.items()}))
        ema.update(unflatten_params({k: torch.from_numpy(v) for k, v in new.items()}))
    assert ema.state.count == int(jema.state.count) == 3
    want = flatten_params(jax.device_get(jema.state.shadow))
    got = flatten_params(ema.apply(None))
    for path in want:
        np.testing.assert_allclose(got[path].numpy(), np.asarray(want[path]), atol=1e-6, rtol=0, err_msg=path)
    assert ema.restore() is None


def test_fused_linear_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    B, T, D, V, chunk = 2, 37, 16, 50, 8
    hidden = rng.standard_normal((B, T, D)).astype(np.float32)
    weight = (0.3 * rng.standard_normal((D, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, 30:] = -100

    def jax_loss(h, w):
        return jax_fused_ce(h, w, jnp.asarray(labels), chunk=chunk)[0]

    want, (want_dh, want_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(weight))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(weight).requires_grad_(True)
    loss, n_valid = fused_linear_cross_entropy(h, w, torch.from_numpy(labels), chunk=chunk)
    loss.backward()
    assert int(n_valid) == int(jax_fused_ce(jnp.asarray(hidden), jnp.asarray(weight), jnp.asarray(labels),
                                            chunk=chunk)[1]) == B * T - 12
    assert abs(loss.item() - float(want)) <= 1e-6
    for got, ref in ((h.grad, want_dh), (w.grad, want_dw)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


def test_fused_linear_cross_entropy_bf16_weight_gradient():
    rng = np.random.default_rng(0)
    B, T, D, V, chunk = 2, 512, 32, 256, 32  # 16 chunks, as [2, 4096] tokens at chunk 512
    hidden = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(torch.bfloat16)
    weight = (0.02 * rng.standard_normal((D, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[0, :5] = -100

    def grads(loss_fn):
        h = hidden.clone().requires_grad_(True)
        w = torch.from_numpy(weight).requires_grad_(True)
        loss_fn(h, w).backward()
        return h.grad.float(), w.grad

    port = grads(lambda h, w: fused_linear_cross_entropy(h, w, torch.from_numpy(labels), chunk=chunk)[0])
    full = grads(lambda h, w: causal_lm_loss(h @ w.to(h.dtype), torch.from_numpy(labels)))  # bf16 product
    exact = grads(lambda h, w: causal_lm_loss(h.float() @ w, torch.from_numpy(labels)))  # fp32 product

    def jax_loss(h, w):
        return jax_fused_ce(h, w, jnp.asarray(labels), chunk=chunk)[0]

    _, (_, jax_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(hidden.float().numpy()).astype(jnp.bfloat16), jnp.asarray(weight))
    jax_dw = torch.tensor(np.asarray(jax_dw, dtype=np.float32))

    def gate(got, want):
        return ((got - want).abs() / (2**-7 * want.abs() + 1e-3 * want.abs().max())).max().item()

    port_gate, jax_gate = gate(port[1], full[1]), gate(jax_dw, full[1])
    port_err, jax_err = ((dw - exact[1]).abs().max().item() for dw in (port[1], jax_dw))
    assert gate(port[0], full[0]) <= 1
    assert port_gate <= 1, port_gate
    assert port_err < jax_err / 4, (port_err, jax_err)
    assert jax_gate > 1, jax_gate  # the divergence the port's fp32 accumulation avoids
