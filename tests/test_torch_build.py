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


def test_the_cluster_helpers_live_in_the_shared_header():
    """The forms that run in thread-block clusters (the forward of
    csrc/attention_wide.cu and the backward of attention_bwd_wide.cu, both
    in both dtypes) share, from csrc/ring_attention.cuh, the cluster rule
    (``WideCluster``, ``cluster_blocks``), ``launch_cluster`` (with the
    block's thread count), the tensor-map encoder (``encode_tiled``,
    ``tile_map``, ``f32_map``, ``bf16_map``), the producer (``produce``,
    its lag at m = 1 a template argument), the partials' store
    (``store_partial``), the float32 forms' lo-tile writer (``write_lo``)
    and partial (``partial_blocks``, over a range of 32-column blocks), the
    bf16 forms' partial (``chunk_product``) and the refusal codes: each is
    defined there once and in neither source, both sources use them, and
    the wrapper's refusals are the codes the header returns."""
    from mpi_tpu_torch.gpu import attention

    header = (_build.SRC_DIR / "ring_attention.cuh").read_text()
    defined = {
        "WideCluster": r"template <int D> struct WideCluster \{",
        "cluster_blocks": r"__host__ __device__ constexpr int cluster_blocks\(int nd\)",
        "launch_cluster": r"int launch_cluster\(void \(\*kernel\)\(Args\.\.\.\), dim3 grid, "
                          r"int threads, int C,",
        "encode_tiled": r"EncodeTiled encode_tiled\(\)",
        "tile_map": r"int tile_map\(CUtensorMap\* map, CUtensorMapDataType type,",
        "f32_map": r"int f32_map\(CUtensorMap\* map, const void\* base,",
        "bf16_map": r"int bf16_map\(CUtensorMap\* map, const void\* base,",
        "produce": r"template <int NS, int LAG1, typename Own, typename Unit>\n"
                   r"__device__ __forceinline__ void produce\(",
        "write_lo": r"template <int TS, int BLOCKS>\n__device__ __forceinline__ void write_lo\(",
        "partial_blocks": r"template <int T, int TS, int BLOCKS>\n"
                          r"__device__ __forceinline__ void partial_blocks\(",
        "store_partial": r"template <int NV>\n__device__ __forceinline__ void store_partial\(",
        "chunk_product": r"__device__ __forceinline__ void chunk_product\(",
    }
    for name, pattern in defined.items():
        assert len(re.findall(pattern, header)) == 1, name
    codes = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (100\d);", header)}
    assert codes == {"kBadShape": 1000, "kNoCluster": 1001, "kNoEncoder": 1002, "kBadMap": 1003}
    # the float32 forms' producer, lo tiles and partials: the forward's at
    # lag NS - 2 over half a chunk's 32-column blocks a warpgroup, the
    # backward's at lag 1 over all four
    f32_uses = {"attention_wide.cu": ("produce<NS, NS - 2>(", "write_lo<TS, 2>(lo, st, 2 * wg, t)",
                                      "partial_blocks<T, TS, 2>("),
                "attention_bwd_wide.cu": ("produce<NS, 1>(", "write_lo<TS, 4>(lo, st, 0, t)",
                                          "partial_blocks<T, TS, 4>(")}
    shared = ("launch_cluster<", "cluster_blocks(", "f32_map", "bf16_map", "store_partial<",
              "chunk_product(")
    for source, uses in (("attention_wide.cu", shared), ("attention_bwd_wide.cu", shared)):
        uses += f32_uses[source]
        text = (_build.SRC_DIR / source).read_text()
        for name, pattern in defined.items():
            assert not re.search(pattern, text), (source, name)
        assert not re.search(r"constexpr int k\w+ = 100\d;", text), source
        for use in uses:
            assert use in text, (source, use)
    assert set(attention._REFUSALS) == set(codes.values())
