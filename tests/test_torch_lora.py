"""The port's LoRA exchange and adapter registry against the JAX package's.

- ``LoRAModel``: the seeded init draws the JAX package's adapters bit for
  bit (the port model built with ``from_jax_params``); a fresh adapter
  (B = 0) is the identity; ``merge_and_unload`` gives the JAX package's
  merged kernels to fp32 rounding (rel 1e-6); ``save_pretrained`` directories
  and ``export_adapter`` files cross between the packages in both directions,
  and the registries they load into hold the same weights bitwise.
- ``AdapterRegistry``: one seeded sequence of add / acquire / release /
  evict / remove / reset_refs, a faulted load included, applied to the JAX
  registry and the port's in lockstep: the same results and errors, slots,
  refs, LRU order, ``stats()`` and pool arrays bitwise after every operation;
  and the backend's device copy of the pool (here on the CPU), refreshed
  slot by slot, equal to the host pool bitwise whenever it is read.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.peft import LoRAConfig as JLoRAConfig
from paddlenlp_tpu.peft import LoRAModel as JLoRAModel
from paddlenlp_tpu.serving.tenancy import AdapterRegistry as JAdapterRegistry
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers.conversion_utils import flatten_params as jflatten
from paddlenlp_tpu.transformers.conversion_utils import unflatten_params as junflatten
from paddlenlp_tpu.utils.faults import FAULTS as J_FAULTS
from paddlenlp_tpu_torch.experimental.backend import SingleDeviceBackend
from paddlenlp_tpu_torch.peft import LoRAConfig, LoRAModel
from paddlenlp_tpu_torch.serving.tenancy import AdapterRegistry, adapter_dims_from_config
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, unflatten_params
from paddlenlp_tpu_torch.utils.faults import FAULTS

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, eos_token_id=None, pad_token_id=0)
IDS = np.asarray([[3, 4, 5, 6, 7]], np.int32)
MERGE_RTOL = 1e-6  # merged kernels: fp32 products in two packages, then rounded to the kernel's dtype


@pytest.fixture(scope="module")
def models():
    jm = JLlama.from_config(JLlamaConfig(use_scan_layers=True, **MODEL_KW), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), jax.device_get(jm.params), device="cpu")
    return jm, pm


def _trained_b(lora_params, flatten, unflatten, to_leaf, seed=5):
    """The adapters with seeded non-zero B: what a trained adapter looks like."""
    rng = np.random.default_rng(seed)
    flat = dict(flatten(lora_params))
    for p in sorted(flat):
        if p.endswith("lora_B"):
            flat[p] = to_leaf(rng.standard_normal(tuple(flat[p].shape)).astype(np.float32) * 0.05)
    return unflatten(flat)


def _pair(models, r=4, alpha=8, rslora=False):
    """(JAX LoRAModel, port LoRAModel) over the same base, with the same
    trained B."""
    jm, pm = models  # copies of the model objects: merge_and_unload rebinds their params
    jl = JLoRAModel(copy.copy(jm), JLoRAConfig(r=r, lora_alpha=alpha, rslora=rslora))
    pl = LoRAModel(copy.copy(pm), LoRAConfig(r=r, lora_alpha=alpha, rslora=rslora))
    jl.params = _trained_b(jl.params, jflatten, junflatten, jnp.asarray)
    pl.params = _trained_b(pl.params, flatten_params, unflatten_params, torch.from_numpy)
    return jl, pl


def _lora_leaves(flat):
    return {p: np.asarray(v) for p, v in flat.items() if "/lora_" in p}


def test_seeded_init_matches_jax_and_zero_b_is_identity(models):
    jm, pm = models
    jl = JLoRAModel(copy.copy(jm), JLoRAConfig(r=4))
    pl = LoRAModel(copy.copy(pm), LoRAConfig(r=4))
    want = _lora_leaves(jflatten(jax.device_get(jl.params)))
    got = _lora_leaves({p: v.numpy() for p, v in flatten_params(pl.params).items()})
    assert sorted(got) == sorted(want) and len(got) == 14  # 7 projections x A/B
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    assert got["model/layers/self_attn/q_proj/lora_A"].shape == (2, 64, 4)  # [L, in, r] on the stack
    ids = torch.from_numpy(IDS)
    torch.testing.assert_close(pl(ids), pm(ids), rtol=0, atol=0)  # B = 0: W + 0 is W
    mask = flatten_params(pl.trainable_mask())
    assert sum(mask.values()) == 14 and all(mask[p] == ("/lora_" in p) for p in mask)


@pytest.mark.parametrize("rslora", [False, True], ids=["alpha_over_r", "rslora"])
def test_merge_and_unload_matches_jax(models, rslora):
    jl, pl = _pair(models, r=4, alpha=8, rslora=rslora)
    assert pl.lora_config.scaling == jl.lora_config.scaling
    jflat = {p: np.asarray(v) for p, v in jflatten(jax.device_get(jl.merge_and_unload().params)).items()}
    merged = pl.merge_and_unload()
    pflat = {p: v.numpy() for p, v in flatten_params(merged.params).items()}
    assert sorted(pflat) == sorted(jflat) and not any("/lora_" in p for p in pflat)
    for p in jflat:
        np.testing.assert_allclose(pflat[p], jflat[p], rtol=MERGE_RTOL, atol=MERGE_RTOL, err_msg=p)
    # the merged model's forward is the LoRA facade's forward
    jl2, pl2 = _pair(models, r=4, alpha=8, rslora=rslora)
    ids = torch.from_numpy(IDS)
    torch.testing.assert_close(merged(ids), pl2(ids), rtol=0, atol=0)


def test_save_pretrained_crosses_both_ways(models, tmp_path):
    jl, pl = _pair(models)
    jl.save_pretrained(str(tmp_path / "jax"))
    pl.save_pretrained(str(tmp_path / "port"))
    assert os.path.isfile(tmp_path / "port" / "lora_model.safetensors")
    jm, pm = models
    from_jax = LoRAModel.from_pretrained(copy.copy(pm), str(tmp_path / "jax"))
    from_port = JLoRAModel.from_pretrained(copy.copy(jm), str(tmp_path / "port"))
    want = _lora_leaves(jflatten(jax.device_get(jl.params)))
    for loaded in (_lora_leaves({p: v.numpy() for p, v in flatten_params(from_jax.params).items()}),
                   _lora_leaves(jflatten(jax.device_get(from_port.params)))):
        assert sorted(loaded) == sorted(want)
        for p in want:
            np.testing.assert_array_equal(loaded[p], want[p], err_msg=p)
    assert from_jax.lora_config == pl.lora_config


def test_export_adapter_crosses_into_both_registries(models, tmp_path):
    jl, pl = _pair(models, r=4, alpha=8)  # scaling 2.0 rides the file's metadata
    cfg = pl.config
    jpath, ppath = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jexp, pexp = jl.export_adapter(jpath), pl.export_adapter(ppath)
    assert sorted(pexp) == sorted(jexp) and len(pexp) == 14
    for k in jexp:
        np.testing.assert_array_equal(pexp[k], jexp[k], err_msg=k)
    jreg = JAdapterRegistry(config=jl.config, max_rank=4)
    preg = AdapterRegistry(config=cfg, max_rank=4)
    # JAX -> port and port -> JAX, by file (scaling in metadata) and by dict
    digests = {preg.add("jax-file", jpath), preg.add("jax-dict", jexp, scaling=2.0),
               jreg.add("port-file", ppath), jreg.add("port-dict", pexp, scaling=2.0)}
    assert len(digests) == 1
    want = jreg.weights_of("port-file")
    for got in (preg.weights_of("jax-file"), preg.weights_of("jax-dict"), jreg.weights_of("port-dict")):
        assert sorted(got) == sorted(want)
        for proj in want:
            for part in ("A", "B"):
                np.testing.assert_array_equal(got[proj][part], want[proj][part], err_msg=f"{proj}.{part}")
    np.testing.assert_array_equal(want["q_proj"]["B"], jexp["q_proj.lora_B"] * np.float32(2.0))


def test_not_ported_parts_name_their_roadmap_item(models):
    pl = LoRAModel(copy.copy(models[1]), LoRAConfig(r=2))
    with pytest.raises(NotImplementedError, match="item 12b"):
        pl.get_partition_rules_instance()
    # the training forward is ported (its training parity is in tests/test_torch_peft_train.py): it
    # computes the merged model's logits
    pl.params = _trained_b(pl.params, flatten_params, unflatten_params, torch.from_numpy)
    ids = torch.from_numpy(IDS)
    torch.testing.assert_close(pl.forward(ids), pl(ids), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- AdapterRegistry
POOL_SLOTS, MAX_RANK, N_OPS = 3, 4, 160
#: how often each operation is drawn ("copy": the backend brings its device
#: copy up to date, as a step does before it reads the pool)
OP_WEIGHTS = {"add": .16, "acquire": .3, "release": .2, "remove": .07, "reset_refs": .03, "faulted_acquire": .12,
              "copy": .12}


def _source(cfg, seed, rank):
    rng = np.random.default_rng(seed)
    return {proj: {"A": rng.standard_normal((cfg.num_hidden_layers, d_in, rank)).astype(np.float32),
                   "B": rng.standard_normal((cfg.num_hidden_layers, rank, d_out)).astype(np.float32)}
            for proj, (d_in, d_out) in adapter_dims_from_config(cfg).items()
            if seed % 3 or proj != "down_proj"}  # some adapters leave a projection out


def _registry_state(reg):
    return dict(slots=dict(reg._slots), refs=dict(reg._refs), lru=list(reg._lru), free=list(reg._free),
                store={k: (e.digest, e.rank) for k, e in reg._store.items()}, stats=reg.stats(),
                ids=reg.ids(), resident=reg.resident())


def _assert_pools_equal(got, want):
    assert sorted(got) == sorted(want)
    for proj in want:
        for part in ("A", "B"):
            np.testing.assert_array_equal(np.asarray(got[proj][part]), want[proj][part], err_msg=f"{proj}.{part}")


ERRORS = ("AdapterPressure", "InjectedFault", "UnknownAdapterError", "ValueError")


def _apply(reg, faults, cfg, op, args):
    """Run one op; returns its result or the name of the error it raised."""
    try:
        if op == "add":
            aid, seed, rank, scaling = args
            return reg.add(aid, _source(cfg, seed, rank), scaling=scaling)
        if op == "faulted_acquire":
            faults.arm("engine.adapter_load", nth=1)
            try:
                return reg.acquire(args[0])
            finally:
                faults.reset()
        return getattr(reg, op)(*args)
    except Exception as e:
        assert type(e).__name__ in ERRORS, e
        return type(e).__name__


def test_registry_sequence_matches_jax_and_device_copy(models):
    pm = models[1]
    cfg = pm.config
    jreg = JAdapterRegistry(config=cfg, max_rank=MAX_RANK, pool_slots=POOL_SLOTS)
    preg = AdapterRegistry(config=cfg, max_rank=MAX_RANK, pool_slots=POOL_SLOTS)
    backend = SingleDeviceBackend(pm, max_batch_size=1, block_size=4, num_blocks=8, max_blocks_per_seq=4,
                                  dtype=torch.float32, decode_steps=1, eos_ids=set(), adapter_registry=preg)
    rng = np.random.default_rng(0)
    aids = [f"ad-{i}" for i in range(6)]
    seen, copies = set(), 0
    for step in range(N_OPS):
        aid = aids[rng.integers(len(aids))]
        kind = rng.choice(list(OP_WEIGHTS), p=list(OP_WEIGHTS.values()))
        if kind == "copy":  # what a step does before it reads the pool
            dev = backend._lora_tree()
            _assert_pools_equal({p: {k: t.numpy() for k, t in w.items()} for p, w in dev.items()}, preg._pool)
            copies += 1
            continue
        if kind == "add":
            args = (aid, int(rng.integers(1 << 16)), int(rng.integers(1, MAX_RANK + 1)),
                    [None, 0.5, 2.0][rng.integers(3)])
        elif kind == "release" and preg.refcount(aid) == 0:
            continue  # the engine releases only what it acquired
        elif kind == "reset_refs":
            args = ()
        else:
            args = (aid,)
        jr = _apply(jreg, J_FAULTS, cfg, kind, args)
        pr = _apply(preg, FAULTS, cfg, kind, args)
        assert pr == jr, (step, kind, args)
        seen.add(pr if pr in ERRORS else kind)
        assert _registry_state(preg) == _registry_state(jreg), (step, kind, args)
        _assert_pools_equal(preg._pool, jreg._pool)
    stats = preg.stats()
    # the sequence reached every path: loads, LRU evictions, pool pressure, a
    # faulted load, refused removals of in-use adapters
    assert stats["loads"] > 5 and stats["evictions"] > 3 and copies > 5, stats
    assert set(ERRORS) <= seen, seen
    dev = backend._lora_tree()
    _assert_pools_equal({p: {k: t.numpy() for k, t in w.items()} for p, w in dev.items()}, preg._pool)


def test_device_copy_under_concurrent_admin_threads(models):
    """Two admin threads add and remove adapters while a loop thread acquires,
    releases and refreshes the backend's device copy, with the interpreter
    switching threads every 10 us, for a bounded time: once they stop, one
    more refresh gives a device copy equal to the host pool bitwise (a copy
    that read a slot while an admin thread rewrote it, and took the newer
    version, would stay stale)."""
    import sys
    import threading
    import time

    from paddlenlp_tpu_torch.serving.tenancy import AdapterPressure, UnknownAdapterError

    pm = models[1]
    cfg = pm.config
    reg = AdapterRegistry(config=cfg, max_rank=MAX_RANK, pool_slots=2)
    backend = SingleDeviceBackend(pm, max_batch_size=1, block_size=4, num_blocks=8, max_blocks_per_seq=4,
                                  dtype=torch.float32, decode_steps=1, eos_ids=set(), adapter_registry=reg)
    sources = [_source(cfg, seed, 1 + seed % MAX_RANK) for seed in range(1, 9)]
    stop, errors, refreshes = threading.Event(), [], [0]

    def admin(k):
        i = 0
        while not stop.is_set():
            try:  # keep about two of this thread's adapters registered
                reg.add(f"ad-{k}-{i % 4}", sources[(4 * k + i) % len(sources)])
                reg.remove(f"ad-{k}-{(i + 2) % 4}")
            except (ValueError, UnknownAdapterError):  # in use by the loop thread, or not registered
                pass
            except Exception as e:
                errors.append(e)
            i += 1

    def loop():
        while not stop.is_set():
            for aid in reg.ids()[:2]:
                try:
                    reg.acquire(aid)
                    backend._lora_tree()
                    reg.release(aid)
                except (AdapterPressure, UnknownAdapterError):
                    pass
                except Exception as e:
                    errors.append(e)
            backend._lora_tree()
            refreshes[0] += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=admin, args=(k,)) for k in range(2)] + [threading.Thread(target=loop)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert refreshes[0] > 10 and reg.stats()["loads"] > 5, (refreshes, reg.stats())
    dev = backend._lora_tree()
    _assert_pools_equal({p: {k: t.numpy() for k, t in w.items()} for p, w in dev.items()}, reg._pool)
