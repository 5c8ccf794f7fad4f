"""The kernels' build cache (``paddlenlp_tpu_torch/ops/_build.py``): a
source's library is named by a hash of the source, the local headers it
includes (transitively) and the flags, so a changed header rebuilds every
source that includes it and nothing else does."""

from paddlenlp_tpu_torch.ops import _build


def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text('#include "a.cuh"  // a cycle is read once\n')
    (csrc / "unused.cuh").write_text("// included by nothing\n")
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n  #  include "a.cuh"\n#include "b.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "SOURCES", {"k": "k.cu"})
    assert [p.name for p in _build._files("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build.library_path("k")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")
    (csrc / "unused.cuh").write_text("// changed, still included by nothing\n")
    assert _build.library_path("k") == first
    (csrc / "b.cuh").write_text('#include "a.cuh"\n// changed\n')
    second = _build.library_path("k")
    assert second != first
    (csrc / "k.cu").write_text('#include "a.cuh"\n// changed\n')
    assert _build.library_path("k") not in (first, second)


def test_the_sources_hash_the_shared_header():
    """The sources that include ``common.cuh`` (the cp.async, mma and opt-in
    helpers) hash it; the bf16 flash source includes no local header."""
    files = {stem: [p.name for p in _build._files(stem)] for stem in _build.SOURCES}
    assert files == {"paged_attention_sm90": ["paged_attention_sm90.cu", "common.cuh"],
                     "flash_attention_sm90": ["flash_attention_sm90.cu"],
                     "flash_attention_sm90_f32": ["flash_attention_sm90_f32.cu", "common.cuh"]}
