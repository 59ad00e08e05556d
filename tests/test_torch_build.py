"""The kernel build's cache key (mpi_tpu_torch/_build.py): a library is
named by the hash of its source, of every csrc/ header the source includes
(directly or through another header) and of the flags, so an edited header
never loads a stale library."""

from mpi_tpu_torch import _build


def test_editing_an_included_header_changes_the_target(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    (tmp_path / "c.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    first = _build._target("k")
    assert [p.name for p in _build._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    (tmp_path / "c.cuh").write_text("// edited, but nothing includes it\n")
    assert _build._target("k") == first
    (tmp_path / "b.cuh").write_text("// two\n")  # included through a.cuh
    second = _build._target("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    third = _build._target("k")
    assert third not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._target("k") not in (first, second, third)


def test_every_source_has_its_signatures_and_headers():
    """Each library of SIGNATURES is a csrc/ source; the backward kernels
    are their own source, built beside the forward.  Both include the
    ring-attention header they share, and through it the Hopper header:
    both are in their keys."""
    assert set(_build.SIGNATURES) == {"ring", "attention", "attention_bwd"}
    for name in _build.SIGNATURES:
        assert (_build.SRC_DIR / f"{name}.cu").exists(), name
    assert set(_build.SIGNATURES["attention_bwd"]) == {"attn_bwd_dq", "attn_bwd_dkv"}
    for name in ("attention", "attention_bwd"):
        assert [p.name for p in _build._sources(name)] == [f"{name}.cu", "ring_attention.cuh",
                                                           "hopper.cuh"]
    assert [p.name for p in _build._sources("ring")] == ["ring.cu"]
