"""The kernels' launch counters hold under concurrent launches.

Several in-process replicas behind one router run one engine loop thread each,
and each loop launches the paged kernel on its own. ``chip_smoke.py`` reads
the counters to prove every launch took the Hopper route, so a bump lost to a
race would either fail that check or hide a wrong route. Here eight threads
drive each wrapper's counting path with the native launch stubbed, and the
counts must sum exactly.
"""

import contextlib
import sys
import threading
import types

import pytest
import torch

from paddlenlp_tpu_torch.ops import flash_attention as fa
from paddlenlp_tpu_torch.ops import paged_attention as pa

THREADS = 8
PER_THREAD = 2000


@pytest.fixture
def tight_switching():
    """Switch threads as often as CPython allows, so an unguarded ``+=``
    loses bumps within a few thousand."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(old)


def _hammer(fn):
    start = threading.Barrier(THREADS)
    errors = []

    def run():
        try:
            start.wait(timeout=30)
            for _ in range(PER_THREAD):
                fn()
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a launching thread hung"
    assert not errors, errors


@pytest.mark.parametrize("route", ["sm90", "sm90_quant", "simt"])
def test_paged_counts_sum_exactly_across_threads(monkeypatch, tight_switching, route):
    calls = []
    monkeypatch.setattr(pa, "_kernel_fn", lambda r: (lambda *args: calls.append(r) or 0))
    monkeypatch.setattr(pa, "LAUNCHES", 0)
    monkeypatch.setattr(pa, "LAUNCHES_SM90", 0)
    monkeypatch.setattr(pa, "LAUNCHES_SM90_QUANT", 0)
    _hammer(lambda: pa._launch(route, 1, 2, 3))
    n = THREADS * PER_THREAD
    assert len(calls) == n and set(calls) == {route}
    assert pa.LAUNCHES == n
    assert pa.LAUNCHES_SM90 == (0 if route == "simt" else n)
    assert pa.LAUNCHES_SM90_QUANT == (n if route == "sm90_quant" else 0)


def test_paged_refused_launch_counts_nothing(monkeypatch):
    monkeypatch.setattr(pa, "_kernel_fn", lambda r: (lambda *args: 700))
    monkeypatch.setattr(pa, "LAUNCHES", 0)
    monkeypatch.setattr(pa, "LAUNCHES_SM90", 0)
    with pytest.raises(RuntimeError, match="pdnlp_ragged_paged_attention_sm90\\)"):
        pa._launch("sm90", 1)
    assert pa.LAUNCHES == pa.LAUNCHES_SM90 == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["sm90", "simt"])
def test_flash_counts_sum_exactly_across_threads(monkeypatch, tight_switching, dtype):
    symbols = []
    monkeypatch.setattr(fa, "_kernel_fn", lambda stem, symbol, n_ptr, n_int: (
        lambda *args: symbols.append(symbol) or 0))
    # the launch path's only CUDA calls: select the device, read its stream
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fa, "LAUNCHES", {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0})
    monkeypatch.setattr(fa, "LAUNCHES_SM90", {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0})
    q = torch.zeros(1, 4, 2, 8, dtype=dtype)
    k = torch.zeros(1, 4, 1, 8, dtype=dtype)
    whats = ["fwd", "bwd_dq", "bwd_dkv"]
    counter = iter(range(10**9))
    lock = threading.Lock()

    def launch():
        with lock:
            what = whats[next(counter) % 3]
        fa._launch("pdnlp_flash_" + what, 0, [], q, k, True, None, None, what)

    _hammer(launch)
    n = THREADS * PER_THREAD
    assert len(symbols) == n
    assert sum(fa.LAUNCHES.values()) == n
    assert all(v in (n // 3, n // 3 + 1) for v in fa.LAUNCHES.values()), fa.LAUNCHES
    expect = fa.LAUNCHES if dtype == torch.bfloat16 else {w: 0 for w in whats}
    assert fa.LAUNCHES_SM90 == expect
