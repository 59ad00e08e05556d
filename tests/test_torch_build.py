"""The kernel build's cache key (mpi_tpu_torch/_build.py): a library is
named by the hash of its source, of every csrc/ header the source includes
(directly or through another header) and of the flags, so an edited header
never loads a stale library."""

import re

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
    are their own source, built beside the forward, and the forms above
    d = 256 are two more sources, built beside them.  All four include the
    ring-attention header they share, and through it the Hopper header:
    both are in their keys.  The peer-memory source of worlds that span
    processes has no header.  Every ``extern "C"`` function of a source
    has its signature, and no signature lacks its function."""
    assert set(_build.SIGNATURES) == {"ring", "attention", "attention_bwd", "peers",
                                      "attention_wide", "attention_bwd_wide"}
    for name in _build.SIGNATURES:
        src = _build.SRC_DIR / f"{name}.cu"
        assert src.exists(), name
        exported = set(re.findall(r'extern "C" int (\w+)\(', src.read_text()))
        assert exported == set(_build.SIGNATURES[name]), name
    assert set(_build.SIGNATURES["attention_bwd"]) == {"attn_bwd_dq", "attn_bwd_dkv"}
    # and the probe of how TF32 wgmma reads a raw float32 word (a card test's)
    assert set(_build.SIGNATURES["attention_bwd_wide"]) == {"attn_bwd_dq_wide",
                                                            "attn_bwd_dkv_wide",
                                                            "wgmma_tf32_probe"}
    # a wide entry point takes the arguments of its d <= 256 counterpart
    for name in ("attn_fwd", "attn_bwd_dq", "attn_bwd_dkv"):
        src = "attention" if name == "attn_fwd" else "attention_bwd"
        assert (_build.SIGNATURES[src + "_wide"][name + "_wide"]
                == _build.SIGNATURES[src][name]), name
    for name in ("attention", "attention_bwd", "attention_wide", "attention_bwd_wide"):
        assert [p.name for p in _build._sources(name)] == [f"{name}.cu", "ring_attention.cuh",
                                                           "hopper.cuh"]
    assert [p.name for p in _build._sources("ring")] == ["ring.cu"]
    assert [p.name for p in _build._sources("peers")] == ["peers.cu"]
