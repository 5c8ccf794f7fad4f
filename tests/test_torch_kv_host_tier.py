"""The port's host KV tier against the JAX package's, on one tiny model.

Mirrors ``tests/experimental/test_kv_host_tier.py`` (its tensor-parallel
cases belong to ROADMAP Queue 1 item 12): a small device pool whose churn
LRU-evicts prefix blocks into the host tier, and prompts that promote them
back. The port must stream the tokens the JAX package streams (a
never-evicting JAX engine is the reference), and under the same traffic its
``BlockManager`` and tier must hold the same state as the JAX engine's:
free list, tables, prefix index, LRU order, tier entries in LRU order and
the tier's counters. Both fault points degrade as in the reference; a CUDA
error that poisoned the context propagates instead (port only). The last
test checks, through a stand-in for the CUDA streams, that a spill's gather
reads the bytes from before the launch that rewrites its block and that a
promote lands before the first launch that reads its blocks, not before.
"""

import jax
import numpy as np
import pytest
import torch

from paddlenlp_tpu.experimental import InferenceEngine as JEngine
from paddlenlp_tpu.experimental import SamplingParams as JSamplingParams
from paddlenlp_tpu.experimental.kv_host_tier import HostKVTier as JHostKVTier
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
from paddlenlp_tpu_torch.experimental.kv_host_tier import HostKVTier
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM
from paddlenlp_tpu_torch.utils.faults import FAULTS

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, eos_token_id=None, pad_token_id=0)
BS = 4
PREFIX = list(range(5, 21))  # 4 full blocks
CHURN = [22 + i for i in range(44)]  # 11 blocks + decode: floods the pool
GREEDY = dict(max_new_tokens=8)
SAMPLED = dict(max_new_tokens=8, do_sample=True, top_p=0.9, seed=7)
# a SMALL device pool (churn forces LRU eviction) over a roomy host tier
HOST = dict(max_batch_size=2, block_size=BS, num_blocks=15, max_blocks_per_seq=16, enable_prefix_cache=True,
            host_kv_blocks=64)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


@pytest.fixture(scope="module")
def models():
    jm = JLlama.from_config(JLlamaConfig(use_scan_layers=True, **MODEL_KW), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), jax.device_get(jm.params), device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def reference(models):
    """Ground truth: a JAX engine with no cache and a pool that never evicts.
    ``reference(prompts, **sampling)`` -> its streams."""
    eng = JEngine(models[0], max_batch_size=2, block_size=BS, num_blocks=64, max_blocks_per_seq=16,
                  enable_prefix_cache=False)
    return lambda prompts, **sp: [list(map(int, o)) for o in eng.generate(prompts, JSamplingParams(**sp))]


def _gen(eng, prompts, **sp):
    return [list(map(int, o)) for o in eng.generate(prompts, SamplingParams(**sp))]


def tier_conserved(eng):
    """Resident-XOR between the tiers, the tier's batch refcounts and the
    device-side block partition."""
    mgr, tier = eng.mgr, eng._host_tier
    assert not (set(mgr._index) & set(tier._entries)), "chain hash resident in BOTH tiers"
    assert tier.num_blocks <= tier.max_blocks
    batches = {id(b): b for b, _row in tier._entries.values()}
    assert sum(b.live for b in batches.values()) == len(tier._entries)
    owned = {b for blocks in mgr.tables.values() for b in blocks}
    assert len(mgr.free) + len(mgr._lru) + len(owned) == mgr.total_usable_blocks


def state(eng):
    """The allocator's and the tier's host-side state, comparable across packages."""
    mgr, tier = eng.mgr, eng._host_tier
    return dict(free=list(mgr.free), tables={k: list(v) for k, v in mgr.tables.items()},
                index=dict(mgr._index), lru=list(mgr._lru), ref=dict(mgr.ref), evictions=mgr.evictions,
                hits=mgr.cache_hits, cached=mgr.cached_tokens_total,
                entries=[(h, row) for h, (_b, row) in tier._entries.items()], stats=dict(tier.stats),
                host=eng.stats()["prefix_cache"]["host"])


def spill_then_promote(eng, warm_tail, target_tail, **sp):
    """Warm PREFIX into the device cache, churn it out to the host tier, then
    run a PREFIX-sharing prompt that must promote; returns its stream."""
    gen = _gen if isinstance(eng, InferenceEngine) else \
        (lambda e, p, **s: [list(map(int, o)) for o in e.generate(p, JSamplingParams(**s))])
    gen(eng, [PREFIX + warm_tail], **sp)
    spills0 = eng._host_tier.stats["spills"]
    gen(eng, [CHURN], max_new_tokens=4)
    assert eng._host_tier.stats["spills"] > spills0, "churn never spilled"
    promoted0 = eng._host_tier.stats["promoted_blocks"]
    out = gen(eng, [PREFIX + target_tail], **sp)[0]
    assert eng._host_tier.stats["promoted_blocks"] >= promoted0 + 4, "the target prompt did not promote"
    tier_conserved(eng)
    return out


# ----------------------------------------------------------------------------- the tier alone
def _batch(n, seed):
    return np.random.default_rng(seed).standard_normal((2, 2, n, 2, BS, 8)).astype(np.float32)


def _port_tier(max_blocks, block_bytes=0):
    """The port's tier over a CPU arena for ``_batch``'s [2, 2, BS, 8] blocks."""
    return HostKVTier(max_blocks, block_bytes, planes=[torch.zeros((max_blocks, 2, 2, 2, BS, 8))])


def _port_put(tier, hashes, kv):
    """Spill rows of ``kv`` [L, 2, n, ...] (the JAX tier's layout) into the
    port's arena, as the engine does: reserve slots, copy, register."""
    slots = tier.reserve(hashes)
    kept = len(hashes) - len(slots)
    tier.planes[0][slots] = torch.from_numpy(kv).movedim(2, 0)[kept:]
    tier.put(hashes[kept:], slots)


def _port_take(tier, hashes):
    slots, nbytes = tier.take(hashes)
    return tier.planes[0][slots].movedim(0, 2).numpy(), nbytes


def test_put_take_roundtrip_bitwise():
    jtier, ptier = JHostKVTier(8, block_bytes=2 * 2 * 2 * BS * 8 * 4), _port_tier(8, 2 * 2 * 2 * BS * 8 * 4)
    kv = _batch(3, 0)
    jtier.put([b"a", b"b", b"c"], kv)
    _port_put(ptier, [b"a", b"b", b"c"], kv)
    jkv, jscale, jn = jtier.take([b"b", b"c"])
    pkv, pn = _port_take(ptier, [b"b", b"c"])
    np.testing.assert_array_equal(pkv, kv[:, :, 1:3])
    np.testing.assert_array_equal(pkv, jkv)
    assert jscale is None and pn == jn == 2 * ptier.block_bytes
    assert ptier.num_blocks == 1 and not ptier.contains(b"b")
    assert ptier.snapshot() == jtier.snapshot()


def test_lru_eviction_and_respill():
    snaps = []
    for tier, put, take in ((JHostKVTier(3), JHostKVTier.put, lambda t, h: t.take(h)[0]),
                            (_port_tier(3), _port_put, lambda t, h: _port_take(t, h)[0])):
        put(tier, [b"a", b"b"], _batch(2, 1))
        put(tier, [b"c", b"a"], _batch(2, 2))  # re-spill of a: newest wins
        assert tier.num_blocks == 3 and tier.stats["evictions"] == 0
        put(tier, [b"d"], _batch(1, 3))  # capacity 3: the oldest (b) goes
        snaps.append((list(tier._entries), [row for _b, row in tier._entries.values()], tier.snapshot()))
        assert not tier.contains(b"b") and tier.contains(b"a")
        np.testing.assert_array_equal(np.asarray(take(tier, [b"a"])), _batch(2, 2)[:, :, 1:2])
        tier.clear()
        assert tier.num_blocks == 0
    assert snaps[1] == snaps[0]


def test_disabled_tier_accepts_nothing():
    tier = _port_tier(0)
    assert not tier.accepting
    assert tier.reserve([b"a"]) == []
    tier.put([b"a"], [])
    assert tier.num_blocks == 0 and tier.snapshot() == JHostKVTier(0).snapshot()


# ----------------------------------------------------------------------------- the engine
def test_promoted_streams_and_state_match_jax(models, reference):
    """(a) greedy and seeded streams after a promote equal the never-evicting
    reference's, and (b) the port's allocator and tier hold the JAX host-tier
    engine's state after the same traffic."""
    jm, pm = models
    jeng, peng = JEngine(jm, **HOST), InferenceEngine(pm, **HOST)
    for warm, target, sp in (([60, 61], [62, 63], GREEDY), ([64, 65], [66, 67], SAMPLED)):
        got = spill_then_promote(peng, warm, target, **sp)
        assert got == spill_then_promote(jeng, warm, target, **sp)
        reference([PREFIX + warm], **sp)
        assert got == reference([PREFIX + target], **sp)[0]
        assert state(peng) == state(jeng)


def test_chunked_prefill(models, reference):
    eng = InferenceEngine(models[1], **HOST, prefill_chunk_tokens=8)
    got = spill_then_promote(eng, [68, 69], [70, 71], **GREEDY)
    reference([PREFIX + [68, 69]], **GREEDY)
    assert got == reference([PREFIX + [70, 71]], **GREEDY)[0]


def test_generated_blocks_registered_and_reused(models, reference):
    """A turn-2 prompt threading turn 1's completion back reuses the
    completion's blocks too, not just the prompt's."""
    eng = InferenceEngine(models[1], **dict(HOST, num_blocks=64))  # no eviction
    p1 = [3] + PREFIX + [4]  # 18 tokens
    out1 = _gen(eng, [p1], **GREEDY)[0]
    turn2 = p1 + out1 + [76, 77]
    cached0 = eng.mgr.cached_tokens_total
    out2 = _gen(eng, [turn2], **GREEDY)[0]
    assert eng.mgr.cached_tokens_total - cached0 >= (len(p1) + len(out1)) // BS * BS
    assert out1 == reference([p1], **GREEDY)[0]
    assert out2 == reference([turn2], **GREEDY)[0]


def test_turn2_survives_eviction_via_host_tier(models, reference):
    """The whole turn-1 history (prompt and completion) comes back from the
    host tier after churn evicted it from the device."""
    eng = InferenceEngine(models[1], **HOST)
    p1 = [3] + PREFIX + [4]
    out1 = _gen(eng, [p1], **GREEDY)[0]
    _gen(eng, [[22 + i % 60 for i in range(52)]], max_new_tokens=4)  # every history block evicts
    promoted0 = eng._host_tier.stats["promoted_blocks"]
    turn2 = p1 + out1 + [78, 79]
    out2 = _gen(eng, [turn2], **GREEDY)[0]
    assert eng._host_tier.stats["promoted_blocks"] >= promoted0 + 6
    reference([p1], **GREEDY)
    assert out2 == reference([turn2], **GREEDY)[0]
    tier_conserved(eng)
    assert not eng.mgr.tables and eng.mgr.num_free == eng.mgr.total_usable_blocks  # no block leaks


def test_spill_fault_drops_batch_no_leak(models, reference):
    eng = InferenceEngine(models[1], **HOST)
    _gen(eng, [PREFIX + [80, 81]], **GREEDY)
    FAULTS.arm("engine.kv_spill", times=1)
    blocks0 = eng._host_tier.num_blocks
    got = _gen(eng, [CHURN], max_new_tokens=4)[0]
    assert FAULTS.fired("engine.kv_spill") == 1
    # the faulted batch is GONE (the pre-tier behaviour), nothing half-resident
    assert eng._host_tier.num_blocks <= blocks0 + len(CHURN) // BS
    assert got == reference([CHURN], max_new_tokens=4)[0]
    tier_conserved(eng)


def test_promote_fault_cold_prefill_token_exact(models, reference):
    eng = InferenceEngine(models[1], **HOST)
    _gen(eng, [PREFIX + [82, 83]], **GREEDY)
    _gen(eng, [CHURN], max_new_tokens=4)
    assert eng._host_tier.num_blocks >= 4
    FAULTS.arm("engine.kv_promote", times=1)
    promotes0 = eng._host_tier.stats["promotes"]
    got = _gen(eng, [PREFIX + [84, 85]], **GREEDY)[0]
    assert FAULTS.fired("engine.kv_promote") == 1
    # the fault fired BEFORE take(): no promote happened, the entries stay
    assert eng._host_tier.stats["promotes"] == promotes0
    reference([PREFIX + [82, 83]], **GREEDY)
    assert got == reference([PREFIX + [84, 85]], **GREEDY)[0]
    tier_conserved(eng)


def test_poisoned_context_in_a_promote_propagates(models, monkeypatch):
    """A sticky CUDA error in the promote copy is not a promote failure to
    recover from with a cold prefill: the step raises, and the serving loop
    takes it as a lost device."""
    from paddlenlp_tpu_torch.serving.engine_loop import is_device_fault

    eng = InferenceEngine(models[1], **HOST)
    _gen(eng, [PREFIX + [86, 87]], **GREEDY)
    _gen(eng, [CHURN], max_new_tokens=4)

    def poisoned(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(eng.backend, "kv_promote", poisoned)
    eng.add_request(PREFIX + [88, 89], SamplingParams(**GREEDY))
    with pytest.raises(RuntimeError) as exc:
        eng.step()
    assert is_device_fault(exc.value)


def test_clear_prefix_cache_empties_host_tier(models):
    eng = InferenceEngine(models[1], **HOST)
    _gen(eng, [PREFIX + [86, 87]], **GREEDY)
    _gen(eng, [CHURN], max_new_tokens=4)
    assert eng._host_tier.num_blocks > 0
    eng.clear_prefix_cache()
    assert eng._host_tier.num_blocks == 0 and eng.mgr.num_cached_blocks == 0
    promotes0 = eng._host_tier.stats["promotes"]
    _gen(eng, [PREFIX + [86, 87]], **GREEDY)  # nothing resident anywhere: no promote
    assert eng._host_tier.stats["promotes"] == promotes0
    tier_conserved(eng)


def test_stats_surface(models):
    jm, pm = models
    off = dict(HOST, host_kv_blocks=0)
    for kw in (HOST, off):
        got = InferenceEngine(pm, **kw).stats()["prefix_cache"]["host"]
        assert got == JEngine(jm, **kw).stats()["prefix_cache"]["host"]
        assert got["enabled"] is (kw is HOST) and got["capacity"] == kw["host_kv_blocks"]


def test_host_tier_requires_prefix_cache(models):
    with pytest.raises(ValueError, match="enable_prefix_cache"):
        InferenceEngine(models[1], **dict(HOST, enable_prefix_cache=False, host_kv_blocks=8))


# ----------------------------------------------------------------------------- stream and event ordering
class _Event:
    """A stand-in CUDA event: lands when the test says so."""

    def __init__(self):
        self.landed = False

    def query(self):
        return self.landed

    def synchronize(self):
        self.landed = True


class _Copies:
    """A stand-in for the backend's CUDA copies: copies at once (as the
    device would, in stream order) and logs every call."""

    def __init__(self):
        self.log = []

    def to_host(self, blocks, planes, slots):
        ev = _Event()
        self.log.append(("to_host", ev))
        for t, plane in zip(blocks, planes):
            plane[list(slots)] = t
        return ev

    def to_device(self, planes, slots):
        ev = _Event()
        self.log.append(("to_device", ev))
        return [plane[list(slots)] for plane in planes], ev

    def compute_wait(self, event, tensors):
        self.log.append(("compute_wait", event))


def test_spill_and_promote_ordering_through_a_mock(models):
    """(1) A spill gathered in the same step that reuses its block holds the
    bytes from before that step's launch rewrote it. (2) A promote's blocks
    land (the compute stream waiting on the copy's event first) before the
    first launch whose tables hold one of them, and a launch that reads
    other blocks does not wait; ``migration_ready`` is the event's query."""
    eng = InferenceEngine(models[1], **HOST)
    backend, tier = eng.backend, eng._host_tier
    copies = backend._copies = _Copies()
    _gen(eng, [PREFIX + [60, 61]], **GREEDY)  # 4 prefix blocks registered, idle on the LRU
    before = backend.pool.kv.clone()
    calls = []
    for name in ("kv_spill", "prefill", "decode"):
        real = getattr(backend, name)

        def logged(*args, _name=name, _real=real, **kwargs):
            out = _real(*args, **kwargs)
            calls.append((_name, args))
            return out

        setattr(backend, name, logged)
    _gen(eng, [CHURN], max_new_tokens=4)  # recycles the LRU blocks in its own admission
    assert [c[0] for c in calls[:2]] == ["kv_spill", "prefill"]
    # the churn's prefill rewrote the recycled blocks, yet every spill holds
    # their bytes from before it, in the arena slots it reserved
    spills = [args for name, args in calls if name == "kv_spill"]
    for ids, planes, slots in spills:
        assert not torch.equal(backend.pool.kv[:, :, ids], before[:, :, ids])
        assert torch.equal(planes[0][slots], before[:, :, ids].movedim(2, 0))
    spilled = [b for ids, _p, _s in spills for b in ids]

    # (2) promote into two blocks with the copy still in flight
    slots, _n = tier.take(list(tier._entries)[:2])
    data = tier.planes[0][slots].clone()
    targets = [b for b in range(1, 15) if b not in spilled][:2]
    ticket = backend.kv_promote(99, targets, tier.planes, slots)
    event = copies.log[-1][1]
    assert not backend.migration_ready(ticket)
    other = np.zeros((2, HOST["max_blocks_per_seq"]), np.int32)
    other[0, 0] = next(b for b in range(1, 15) if b not in targets)
    backend.verify(np.zeros((2, 2), np.int32), other, np.zeros(2, np.int32), need_logits=False)
    assert copies.log[-1][0] == "to_device" and backend._promotes  # no wait, nothing landed
    reading = np.zeros((2, HOST["max_blocks_per_seq"]), np.int32)
    reading[0, :2] = targets
    backend.verify(np.zeros((2, 2), np.int32), reading, np.zeros(2, np.int32), need_logits=False)
    assert copies.log[-1] == ("compute_wait", event) and not backend._promotes
    event.landed = True
    assert backend.migration_ready(ticket)
    # the verify then wrote its own two positions into the first target block
    assert torch.equal(backend.pool.kv[:, :, targets[1]], data[1])
