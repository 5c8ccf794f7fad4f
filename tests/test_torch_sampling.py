"""The port's on-device sampler against the JAX package's, bit for bit.

``sample_tokens`` must pick the same ids as the JAX one for greedy decoding,
penalties, top-k, top-p and seeded draws: the port rebuilds
``jax.random.categorical(fold_in(key(seed), position), row)`` from threefry2x32
in integer ops and uses a stable sort where JAX's ``argsort`` is stable.
``generate``'s ``split`` and [B, V] ``categorical`` (``utils/prng.py``) draw
``jax.random``'s bits too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.experimental.inference_model import sample_tokens as jax_sample_tokens
from paddlenlp_tpu_torch.experimental.inference_model import _uniform_rows, sample_tokens
from paddlenlp_tpu_torch.utils import prng

SEEDS = [0, 1, 7, 12345, 2**31 - 1]
POSITIONS = [0, 1, 5, 1000, 65535]
V = 257  # odd on purpose: the random-bit layout must not depend on parity

_jax_sample = jax.jit(jax_sample_tokens)


def _batch(seed, n=len(SEEDS)):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, V)) * 3).astype(np.float32)
    logits[0, :4] = logits[0].max() + 1  # a 4-way tie for the top: argmax and the stable sort take the first
    counts = rng.integers(0, 3, (n, V)).astype(np.int32) * (rng.random((n, V)) < 0.1)
    return logits, counts.astype(np.int32)


def _params(n, **kw):
    base = dict(seeds=np.asarray(SEEDS[:n], np.int32), positions=np.asarray(POSITIONS[:n], np.int32),
                temperature=np.ones(n, np.float32), top_k=np.zeros(n, np.int32),
                top_p=np.ones(n, np.float32), do_sample=np.zeros(n, bool))
    base.update({k: np.asarray(v) for k, v in kw.items()})
    return base


def _both(logits, params, counts=None, penalties=None):
    jkw = {k: jnp.asarray(v) for k, v in params.items()}
    tkw = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in params.items()}
    if counts is not None:
        jkw["counts"], tkw["counts"] = jnp.asarray(counts), torch.from_numpy(counts)
        for name, val in penalties.items():
            arr = np.full(len(logits), val, np.float32)
            jkw[name], tkw[name] = jnp.asarray(arr), torch.from_numpy(arr)
    want = np.asarray(_jax_sample(jnp.asarray(logits), **jkw))
    got = sample_tokens(torch.from_numpy(logits), **tkw).numpy()
    return got, want


def test_uniform_bits_match_jax():
    """The threefry draw itself: fold_in(key(seed), pos) then uniform over
    [tiny, 1), bitwise for every (seed, position) pair."""
    tiny = float(jnp.finfo(jnp.float32).tiny)
    seeds = np.repeat(np.asarray(SEEDS, np.int32), len(POSITIONS))
    positions = np.tile(np.asarray(POSITIONS, np.int32), len(SEEDS))
    want = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.key(int(s)), int(p)), (V,),
                                                   minval=tiny, maxval=1.0))
                     for s, p in zip(seeds, positions)])
    got = _uniform_rows(torch.from_numpy(seeds), torch.from_numpy(positions), V).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_greedy():
    logits, _ = _batch(0)
    got, want = _both(logits, _params(len(SEEDS)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0  # first of the tied maxima


def test_penalties():
    logits, counts = _batch(1)
    penalties = dict(repetition_penalty=1.3, presence_penalty=0.5, frequency_penalty=0.2)
    for do_sample in (False, True):
        got, want = _both(logits, _params(len(SEEDS), do_sample=np.full(len(SEEDS), do_sample)), counts, penalties)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k,top_p,temperature", [(0, 1.0, 1.0), (3, 1.0, 1.0), (0, 0.8, 1.0), (5, 0.9, 0.7),
                                                     (1, 1.0, 1.0), (0, 0.5, 1.5)])
def test_seeded_draws(top_k, top_p, temperature):
    n = len(SEEDS)
    for seed in range(4):
        logits, _ = _batch(10 + seed)
        params = _params(n, do_sample=np.ones(n, bool), top_k=np.full(n, top_k, np.int32),
                         top_p=np.full(n, top_p, np.float32), temperature=np.full(n, temperature, np.float32))
        got, want = _both(logits, params)
        np.testing.assert_array_equal(got, want)


def test_mixed_rows_and_positions():
    """Greedy and sampled rows share one call; every (seed, position) pair of
    the grid draws the JAX token."""
    logits, _ = _batch(3, n=len(SEEDS) * len(POSITIONS))
    n = logits.shape[0]
    params = dict(seeds=np.repeat(np.asarray(SEEDS, np.int32), len(POSITIONS)),
                  positions=np.tile(np.asarray(POSITIONS, np.int32), len(SEEDS)),
                  temperature=np.full(n, 0.9, np.float32), top_k=np.zeros(n, np.int32),
                  top_p=np.full(n, 0.95, np.float32), do_sample=np.arange(n) % 3 != 0)
    got, want = _both(logits, params)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 13, 2**31 - 1, -5])
def test_split_and_categorical_match_jax(seed):
    """``generate``'s draws: ``key(seed)``, then each step ``key, sub =
    split(key)`` and ``categorical(sub, logits)`` over [B, V]: the keys and
    the [B, V] bits bitwise, the uniform floats bitwise, the picked ids
    equal, over odd and even shapes."""
    jkey, key = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jkey)), [int(key[0]), int(key[1])])
    for step, shape in enumerate([(1, 96), (2, 257), (3, 1000), (2, 4096)]):
        jkey, jsub = jax.random.split(jkey)
        key, sub = prng.split(key)
        for jk, k in ((jkey, key), (jsub, sub)):
            np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)), [int(k[0]), int(k[1])])
        np.testing.assert_array_equal(prng.random_bits(sub, shape).numpy().astype(np.uint32),
                                      np.asarray(jax.random.bits(jsub, shape, jnp.uint32)))
        tiny = float(jnp.finfo(jnp.float32).tiny)
        np.testing.assert_array_equal(prng.uniform(sub, shape, minval=tiny).numpy().view(np.uint32),
                                      np.asarray(jax.random.uniform(jsub, shape, minval=tiny)).view(np.uint32))
        logits = (np.random.default_rng(step).standard_normal(shape) * 3).astype(np.float32)
        np.testing.assert_array_equal(prng.categorical(sub, torch.from_numpy(logits)).numpy(),
                                      np.asarray(jax.random.categorical(jsub, jnp.asarray(logits))))
