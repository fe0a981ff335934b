"""The port's per-source nvcc flags (`repro_torch.kernels._build`).

No nvcc is needed: these tests read the flag table and the library names
it hashes.  The bit-exactness contract of B1-B4, of the fused slot step,
of the fused router gate and of the counter-based noise kernel rests on
``-fmad=false`` and on the absence of fast math; flash attention has no
such contract and must not carry the flag.
"""
import pathlib

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

EXACT = ("bp_slot.cu", "bp_slot_step.cu", "bp_topk.cu",
         "bp_topk_route.cu", "bp_route.cu", "counter_hash.cu")
FLASH = ("flash_attention.cu", "flash_attention_sm90.cu")


def source(name):
    return next(s for s in _build.sources() if s.name == name)


def test_every_source_has_flags():
    names = sorted(s.name for s in _build.sources())
    assert names == sorted(EXACT + FLASH)
    for s in _build.sources():
        f = _build.flags(s)
        assert f[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
        assert "-gencode" in f and "arch=compute_90a,code=sm_90a" in f


@pytest.mark.parametrize("name", EXACT)
def test_bit_exact_sources_keep_no_fma_and_no_fast_math(name):
    f = _build.flags(source(name))
    assert f == _build.NVCC_FLAGS + ("-fmad=false",)
    assert not any("fast_math" in x or "fast-math" in x for x in f)


@pytest.mark.parametrize("name", FLASH)
def test_flash_sources_may_fuse(name):
    f = _build.flags(source(name))
    assert not any(x.startswith("-fmad") for x in f)
    assert not any("fast_math" in x or "fast-math" in x for x in f)


@pytest.mark.parametrize("name", EXACT + FLASH)
def test_library_name_follows_the_flags(name, monkeypatch):
    src = source(name)
    before = _build.library_path(src)
    assert before == _build.library_path(src)       # stable
    assert before.parent == _build.BUILD_DIR and before.suffix == ".so"
    monkeypatch.setitem(_build.SOURCE_FLAGS, name,
                        _build.SOURCE_FLAGS[name] + ("-DPROBE=1",))
    assert _build.library_path(src) != before


def test_unknown_source_has_no_flags():
    with pytest.raises(KeyError):
        _build.flags(pathlib.Path("kernels/x/csrc/new_kernel.cu"))


def test_library_name_follows_the_headers(tmp_path):
    """A source's library is named by the headers beside it too: the fused
    slot step and bp_slot.cu share bp_slot_decide.cuh, and an edit there
    must rebuild both."""
    src = tmp_path / "bp_slot_step.cu"
    src.write_text("// source")
    header = tmp_path / "bp_slot_decide.cuh"
    header.write_text("// v1")
    before = _build.library_path(src)
    header.write_text("// v2")
    assert _build.library_path(src) != before
    shared = [s for s in _build.sources()
              if (s.parent / "bp_slot_decide.cuh").is_file()]
    assert sorted(s.name for s in shared) == ["bp_slot.cu", "bp_slot_step.cu"]
