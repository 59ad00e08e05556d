"""The ring-attention forward's plain version (mpi_tpu_torch/gpu/attention.py)
against the JAX Pallas kernel in interpret mode
(mpi_tpu/tpu/pallas_attention.py), on the same numpy inputs.

Tolerances: float32 ``rtol=atol=1e-5``.  Both fold the same blocks in the
same ring order with the same online-softmax algebra and -1e30 mask, but
XLA's and PyTorch's CPU matrix products sum each dot product in their own
order, so the last bits differ.  bfloat16 outputs are
compared as bfloat16 values with ``rtol=atol=2e-2`` (about two bfloat16
ulps): a float32 difference in the last bit can round the same value to
neighbouring bfloat16 numbers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as PS

from mpi_tpu.tpu import default_mesh
from mpi_tpu.tpu.pallas_attention import pallas_ring_attention
import chip_smoke
import mpi_tpu_torch
from mpi_tpu_torch import TorchCommunicator
from mpi_tpu_torch.gpu import attention
from mpi_tpu_torch.interop import to_numpy

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def blocks(P, hq, hkv, sb, d, seed, heads=True):
    rs = np.random.RandomState(seed)
    shape_q = (P, hq, sb, d) if heads else (P, sb, d)
    shape_kv = (P, hkv, sb, d) if heads else (P, sb, d)
    return (rs.randn(*shape_q).astype(np.float32),
            rs.randn(*shape_kv).astype(np.float32),
            rs.randn(*shape_kv).astype(np.float32))


def jax_forward(q, k, v, dt, **kw):
    """``pallas_ring_attention(interpret=True)`` over a 1-D mesh of
    ``q.shape[0]`` devices; one [.., Sb, d] block per device."""
    P = q.shape[0]
    jdt = DT[dt][0]

    def f(qb, kb, vb):
        return pallas_ring_attention(qb[0], kb[0], vb[0], "world", P,
                                     interpret=True, **kw)[None]

    jf = jax.jit(jax.shard_map(f, mesh=default_mesh(P),
                               in_specs=(PS("world"),) * 3,
                               out_specs=PS("world"), check_vma=False))
    out = jf(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    return np.asarray(out.astype(jnp.float32))


def port_forward(q, k, v, dt, groups=None, **kw):
    tdt = DT[dt][1]
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    return to_numpy(attention.ring_attention_world(*t, groups, **kw))


@pytest.mark.parametrize("P,hq,hkv,sb,d,dt,causal", [
    (4, 4, 4, 8, 128, "f32", False),     # MHA
    (4, 4, 2, 8, 128, "f32", True),      # GQA
    (4, 4, 1, 16, 128, "f32", False),    # MQA
    (8, 2, 2, 8, 128, "f32", True),
    (2, 2, 1, 8, 256, "f32", True),
    (4, 4, 2, 16, 128, "bf16", True),
    (4, 2, 2, 16, 128, "bf16", False),
    # head dims above 256, which the card runs on csrc/attention_wide.cu
    (2, 4, 2, 8, 384, "f32", True),      # GQA
    (2, 2, 1, 8, 512, "f32", True),      # MQA
    (2, 2, 2, 8, 512, "f32", False),
    (4, 4, 2, 16, 512, "bf16", True),    # GQA
    (2, 2, 1, 16, 384, "bf16", False),
])
def test_forward_plain_matches_pallas(P, hq, hkv, sb, d, dt, causal):
    q, k, v = blocks(P, hq, hkv, sb, d, seed=P * 100 + hq * 10 + hkv)
    want = jax_forward(q, k, v, dt, causal=causal)
    attention.reset_launches()
    got = port_forward(q, k, v, dt, causal=causal)
    np.testing.assert_allclose(got, want, **TOL[dt])
    assert attention.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


@pytest.mark.parametrize("causal", [False, True])
def test_single_head_layout_and_custom_scale(causal):
    q, k, v = blocks(4, 1, 1, 8, 128, seed=7, heads=False)
    want = jax_forward(q, k, v, "f32", causal=causal, scale=0.25)
    got = port_forward(q, k, v, "f32", causal=causal, scale=0.25)
    assert got.shape == q.shape
    np.testing.assert_allclose(got, want, **TOL["f32"])


def test_lse_is_logsumexp_of_the_scores():
    """``with_lse``: L = m + log l equals the log-sum-exp of each query
    row's scaled scores over the whole (causal) sequence."""
    P, hq, sb, d = 4, 2, 8, 128
    q, k, v = blocks(P, hq, hq, sb, d, seed=3)
    _, lse = attention.ring_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True, with_lse=True)
    S = P * sb
    qs = q.transpose(1, 0, 2, 3).reshape(hq, S, d).astype(np.float64)
    ks = k.transpose(1, 0, 2, 3).reshape(hq, S, d).astype(np.float64)
    s = qs @ ks.transpose(0, 2, 1) / np.sqrt(d)
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    got = lse.numpy().transpose(1, 0, 2).reshape(hq, S)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_size_one_is_local_attention():
    """A communicator of size 1 per rank (each rank alone) attends to its
    own block only, as the reference's ``size == 1`` path (:1042)."""
    q, k, v = blocks(2, 1, 1, 8, 128, seed=5, heads=False)
    mesh = default_mesh(1)
    for causal in (False, True):
        want = np.stack([np.asarray(jax.jit(jax.shard_map(
            lambda a, b, c: pallas_ring_attention(a, b, c, "world", 1,
                                                  causal=causal,
                                                  interpret=True),
            mesh=mesh, in_specs=(PS("world"),) * 3, out_specs=PS("world"),
            check_vma=False))(*(jnp.asarray(x[r]) for x in (q, k, v))))
            for r in range(2)])
        solo = TorchCommunicator(2).split_by(lambda i: i)
        assert solo.size == 1
        got = mpi_tpu_torch.run(
            lambda c, a, b, e: attention.ring_attention(
                a[c.rank], b[c.rank], e[c.rank], solo, causal=causal),
            q, k, v, nranks=2, device="cpu")
        np.testing.assert_allclose(to_numpy(got), want, **TOL["f32"])


@pytest.mark.parametrize("causal", [False, True])
def test_split_communicator_matches_dp_sp_mesh(causal):
    """A split communicator (2 groups of 4 consecutive ranks) runs one ring
    per group, as the reference on a (dp=2, sp=4) mesh."""
    sb, d = 8, 128
    rs = np.random.RandomState(11)
    q, k, v = (rs.randn(2, 4, 2, sb, d).astype(np.float32) for _ in range(3))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "sp"))

    def f(qb, kb, vb):
        return pallas_ring_attention(qb[0, 0], kb[0, 0], vb[0, 0], "sp", 4,
                                     causal=causal, interpret=True)[None, None]

    jf = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(PS("dp", "sp"),) * 3,
                               out_specs=PS("dp", "sp"), check_vma=False))
    with pytest.warns(RuntimeWarning, match="fallback"):
        want = np.asarray(jf(*(jnp.asarray(a) for a in (q, k, v))))
    sub = TorchCommunicator(8).split_by(lambda i: i // 4)
    world = [torch.from_numpy(a.reshape(8, 2, sb, d)) for a in (q, k, v)]
    attention.reset_launches()
    got = mpi_tpu_torch.run(
        lambda c, a, b, e: attention.ring_attention(
            a[c.rank], b[c.rank], e[c.rank], sub, causal=causal),
        *world, nranks=8, device="cpu")
    np.testing.assert_allclose(to_numpy(got).reshape(want.shape), want,
                               **TOL["f32"])
    assert attention.LAUNCHES["fwd"] == 0


def test_interleaved_groups_take_group_order():
    """Groups of interleaved world ranks: each group's sequence is its
    members' blocks in group-rank order, so the world result equals the
    plain version on each group's blocks gathered alone."""
    q, k, v = (torch.from_numpy(a) for a in blocks(8, 2, 1, 8, 128, seed=13))
    groups = [[0, 2, 4, 6], [1, 3, 5, 7]]
    got = attention.ring_attention_world(q, k, v, groups, causal=True)
    for grp in groups:
        alone = attention.ring_attention_world(q[grp], k[grp], v[grp],
                                               causal=True)
        torch.testing.assert_close(got[grp], alone, rtol=0, atol=0)


def _diag(fn, exc, match):
    with pytest.raises(exc, match=match):
        fn()


def test_diagnoses_match_reference():
    """The reference's diagnoses (pallas_attention.py:955-989), by type."""
    z = torch.zeros
    w = attention.ring_attention_world
    _diag(lambda: w(z(2, 1, 1, 8, 128), z(2, 1, 1, 8, 128), z(2, 1, 1, 8, 128)),
          ValueError, r"\[Sb, dh\]")
    _diag(lambda: w(z(2, 2, 8, 128), z(2, 2, 16, 128), z(2, 2, 16, 128)),
          ValueError, "equal")
    _diag(lambda: w(z(2, 2, 8, 128), z(2, 2, 8, 128), z(2, 1, 8, 128)),
          ValueError, "equal")
    _diag(lambda: w(z(2, 2, 8, 128), z(2, 2, 8, 128),
                    z(2, 2, 8, 128, dtype=torch.bfloat16)),
          ValueError, "one dtype")
    _diag(lambda: w(z(2, 3, 8, 128), z(2, 2, 8, 128), z(2, 2, 8, 128)),
          ValueError, "multiple of Hkv")
    _diag(lambda: w(z(2, 4, 8, 128), z(2, 0, 8, 128), z(2, 0, 8, 128)),
          ValueError, "positive multiple")
    f16 = dict(dtype=torch.float16)
    _diag(lambda: w(z(2, 8, 128, **f16), z(2, 8, 128, **f16), z(2, 8, 128, **f16)),
          NotImplementedError, "float32/bfloat16")
    _diag(lambda: w(z(2, 8, 64), z(2, 8, 64), z(2, 8, 64)),
          NotImplementedError, "multiple of 128")
    _diag(lambda: w(z(2, 12, 128), z(2, 12, 128), z(2, 12, 128)),
          NotImplementedError, "multiple of 8")
    bf = dict(dtype=torch.bfloat16)
    _diag(lambda: w(z(2, 8, 128, **bf), z(2, 8, 128, **bf), z(2, 8, 128, **bf)),
          NotImplementedError, "multiple of 16")


def test_kernel_plan_gives_the_byte_arithmetic(monkeypatch):
    """Every head dim the reference takes fits a block in both dtypes: d =
    128 and 256 on the plans of csrc/attention.cu (``FwdBf16Plan``,
    ``FwdF32Plan``) and csrc/attention_bwd.cu, every larger multiple of 128
    on those of csrc/attention_wide.cu and attention_bwd_wide.cu, which
    stream chunks of d and so do not grow with it.  The bytes are read from
    the sources, so these numbers pin the kernels' layout; where a plan
    would not fit, the diagnosis names the kernel, its source and the
    bytes."""
    for d in (128, 256, 384, 512, 1024):
        for dt in (torch.float32, torch.bfloat16):
            attention._kernel_plan(d, dt)
            assert max(attention.kernel_smem_bytes(d, dt).values()) <= attention._SMEM_LIMIT
    # the bf16 forward (csrc/attention.cu FwdBf16Plan): 1 KB of alignment,
    # the 128-row Q tile 128 d x 2, NS one-tile stages of a K or V tile
    # (NS = 6 of 128 x 128 at d = 128, 5 of 64 x 256 at d = 256), 2 NS + 1
    # mbarriers
    assert attention.kernel_smem_bytes(128, torch.bfloat16)["fwd"] == 1024 + 32768 + 6 * 32768 + 13 * 8
    assert attention.kernel_smem_bytes(256, torch.bfloat16)["fwd"] == 1024 + 65536 + 5 * 32768 + 11 * 8
    # the float32 forward: Q tiles of three warpgroups at d = 128 (one at
    # d = 256), sharing the staged K/V tiles
    assert attention.kernel_smem_bytes(128)["fwd"] == 168960
    assert attention.kernel_smem_bytes(256)["fwd"] == 199680
    # the bf16 backward (csrc/attention_bwd.cu DqBf16Plan, DkvBf16Plan): 1 KB
    # of alignment, the own tiles, NS stages of the streamed tiles, the
    # exchange region, a stage's lse and delta rows each, 64 bytes of
    # mbarriers.  dq: 128-row Q and dO 2 x 128 d x 2, NS = 4 stages of
    # 64-row K and V 2 x 64 x 128 x 2 at d = 128, NS = 3 of 32-row ones at
    # d = 256.  dkv, four stages of 32-row Q and dO and 4 x 256 bytes of
    # rows: at d = 128 128-row K and V 65 536, the stages 65 536; at
    # d = 256 64-row K and V 65 536, the stages 131 072, P of two tile
    # parities 16 384
    assert attention.kernel_smem_bytes(128, torch.bfloat16)["bwd_dq"] == 1024 + 65536 + 4 * 32768 + 64
    assert attention.kernel_smem_bytes(256, torch.bfloat16)["bwd_dq"] == 1024 + 131072 + 3 * 32768 + 64
    assert attention.kernel_smem_bytes(128, torch.bfloat16)["bwd_dkv"] == 1024 + 65536 + 4 * 16384 + 4 * 256 + 64
    assert attention.kernel_smem_bytes(256, torch.bfloat16)["bwd_dkv"] == 1024 + 65536 + 4 * 32768 + 16384 + 4 * 256 + 64
    # the float32 backward at d = 128 (DqF32Plan, DkvF32Plan): 1 KB of
    # alignment, 64-row own tiles 2 x 64 x 128 x 4, NS = 2 stages of two
    # 32-row streamed tiles with their lo rows 2 x 65 536, the 64 x 32 B
    # tiles 32 768 (dq: dS hi and lo of two parities, P handed over in
    # them; dkv: P and dS hi and lo), dkv's stage rows 2 x 256, 64 bytes of
    # mbarriers
    assert attention.kernel_smem_bytes(128)["bwd_dq"] == 1024 + 65536 + 2 * 65536 + 32768 + 64
    assert attention.kernel_smem_bytes(128)["bwd_dkv"] == 1024 + 65536 + 2 * 65536 + 32768 + 2 * 256 + 64
    # at d = 256 (DqF32UnitPlan, DkvF32UnitPlan): 1 KB of alignment, 64-row
    # own tiles 2 x 64 x 256 x 4, a ring of NS = 4 units of 16 384 (32 rows
    # x 64 columns raw and lo, or x 128 columns raw), the 64 x 32 B tiles
    # 32 768, dkv's unit rows (lse or delta) 4 x 128, 13 mbarriers (full,
    # empty and lo_full of each slot, the own tiles')
    assert attention.kernel_smem_bytes(256)["bwd_dq"] == 1024 + 131072 + 4 * 16384 + 32768 + 13 * 8
    assert attention.kernel_smem_bytes(256)["bwd_dkv"] == 1024 + 131072 + 4 * 16384 + 32768 + 4 * 128 + 13 * 8
    # above d = 256: the same bytes at every d (the forward's clusters in
    # bf16: 1 KB of alignment, the own 64 x 128 Q chunk 16 384, two stages of
    # a K chunk and a V (or Q) chunk 65 536, two parities of the 64 x 64
    # float32 partial 32 768: two blocks an SM; the bf16 backward's: 1 KB of
    # alignment, the own 64 x 128 tiles 32 768, two stages of two 64 x 128
    # tiles 65 536, two parities of the 64 x 64 partials of S and dP 65 536,
    # the 64 x 64 A tiles (dq: dS hi, mid and lo 24 576; dkv: P and dS
    # 49 152) and the mbarriers; the float32 clusters: 1 KB of alignment, the own 64 x
    # 128 tiles (forward: Q 32 768; backward: two, 65 536), two stages of
    # two 32 x 128 tiles 65 536, their lo tiles (forward: K's 16 384;
    # backward 32 768), two parities of the partials (forward: S 16 384;
    # backward: S and dP 32 768), the 64 x 32 B tiles (forward: P hi and lo
    # 16 384; dq: dS 16 384; dkv: P and dS 32 768), the forward's second
    # warpgroup's half of a partial 8 192 and 1 280 of row maxima, sums and
    # rescales, and the mbarriers)
    for d in (384, 512, 640, 1024, 1152, 2048):
        assert attention.kernel_smem_bytes(d, torch.bfloat16) == {
            "fwd": 115712, "bwd_dq": 189504, "bwd_dkv": 214080}
        assert 2 * (attention.kernel_smem_bytes(d, torch.bfloat16)["fwd"] + 1024) <= 228 * 1024
        assert attention.kernel_smem_bytes(d) == {
            "fwd": 158000, "bwd_dq": 214080, "bwd_dkv": 230464}
        assert attention.kernel_smem_bytes(d)["bwd_dkv"] <= 232_448
    # the diagnosis, where a block would need more than it may use
    monkeypatch.setattr(attention, "_SMEM_LIMIT", 150_000)
    with pytest.raises(NotImplementedError,
                       match=r"bwd_dq kernel \(csrc/attention_bwd_wide.cu\) at head dim "
                             r"512, torch.bfloat16, would need 189504 bytes .* beyond the "
                             r"150000"):
        attention._kernel_plan(512, torch.bfloat16)
    with pytest.raises(NotImplementedError,
                       match=r"fwd kernel \(csrc/attention.cu\) .* 168960 bytes"):
        attention._kernel_plan(128)
    with pytest.raises(NotImplementedError,
                       match=r"fwd kernel \(csrc/attention_wide.cu\) at head dim "
                             r"1024, torch.float32, would need 158000 bytes"):
        attention._kernel_plan(1024)
    # above the forward's 158 000 bytes, the float32 dQ kernel's 214 080
    monkeypatch.setattr(attention, "_SMEM_LIMIT", 200_000)
    with pytest.raises(NotImplementedError,
                       match=r"bwd_dq kernel \(csrc/attention_bwd_wide.cu\) at head dim "
                             r"1024, torch.float32, would need 214080 bytes"):
        attention._kernel_plan(1024)
    monkeypatch.setattr(attention, "_SMEM_LIMIT", 230_463)
    with pytest.raises(NotImplementedError, match=r"bwd_dkv kernel .* 230464 bytes"):
        attention._kernel_plan(640)
    attention._kernel_plan(640, torch.bfloat16)  # bf16: 214080 bytes at most
    # between the bf16 dQ kernel's 189 504 and its dK/dV kernel's 214 080
    monkeypatch.setattr(attention, "_SMEM_LIMIT", 200_000)
    with pytest.raises(NotImplementedError,
                       match=r"bwd_dkv kernel \(csrc/attention_bwd_wide.cu\) at head dim "
                             r"1152, torch.bfloat16, would need 214080 bytes"):
        attention._kernel_plan(1152, torch.bfloat16)


@pytest.mark.parametrize("d,clusters,passes", [
    (384, 3, 1), (512, 4, 1), (640, 5, 1), (1024, 8, 1), (1152, 3, 3), (2048, 8, 2)])
def test_wide_f32_backward_cluster_arithmetic(d, clusters, passes):
    """The float32 backward above d = 256 runs clusters of C blocks, C the
    largest divisor of d / 128 that is at most 8 (the portable cluster
    size), each block m = d / 128 / C passes over its walk, one output
    chunk a pass (``WideCluster`` in csrc/ring_attention.cuh, read from
    the source)."""
    assert attention.wide_cluster(d) == (clusters, passes)
    nd = d // 128
    assert clusters == max(c for c in range(1, 9) if nd % c == 0)
    assert clusters * passes == nd


@pytest.mark.parametrize("d", [384, 512, 640, 768, 896, 1024, 1152, 1280, 1408, 1536,
                               1792, 2048])
def test_wide_forward_cluster_arithmetic(d):
    """The forward above d = 256 (csrc/attention_wide.cu) runs in both
    dtypes the clusters of the float32 backward, read from the source: C
    the largest divisor of d / 128 that is at most 8, m = d / 128 / C
    passes (m = 1 at every d <= 1024: one pass, S formed once a tile).
    chip_smoke.py counts its design floor as (2m + 4) d flops an entry in
    bf16 and 3 (2m + 2) d in float32: at the wide serving shape (P = 8,
    8/2 heads, d = 512, causal S = 32 768) 13.341 and 53.311 ms, the
    narrow forward's floors."""
    C, m = attention.wide_cluster(d)
    nd = d // 128
    assert C == max(c for c in range(1, 9) if nd % c == 0) and C * m == nd
    assert (m == 1) == (d <= 1024)
    assert chip_smoke.wide_floor_flops("bf16", "fwd", d) == 2 * m + 4
    assert chip_smoke.wide_floor_flops("f32", "fwd", d) == 3 * (2 * m + 2)
    if d == 512:
        entries = chip_smoke.causal_entries((8, 8, 2, 4096, 512))
        floor = {key: chip_smoke.wide_floor_flops(key, "fwd", d) * d * entries / rate * 1e3
                 for key, rate in (("bf16", chip_smoke.BF16_FLOPS),
                                   ("f32", chip_smoke.TF32_FLOPS))}
        assert (round(floor["bf16"], 3), round(floor["f32"], 3)) == (13.341, 53.311)


@pytest.mark.parametrize("d", [384, 512, 640, 1024, 1152, 2048])
def test_wide_backward_design_floor(d):
    """The backward above d = 256 (csrc/attention_bwd_wide.cu) forms S and
    dP once a pass of its clusters in both dtypes: chip_smoke.py counts its
    design floor as (4m + 6) d and (4m + 12) d flops an entry in bf16 (dS,
    and P, in three bf16 terms in the output products) and 3 (4m + 2) d
    and 3 (4m + 4) d in float32; at the wide serving shape (P = 8, 8/2
    heads, d = 512, causal S = 32 768) 22.235 and 35.577 ms in bf16, 79.967
    and 106.623 in float32 (the narrow backward's floors)."""
    m = attention.wide_cluster(d)[1]
    assert chip_smoke.wide_floor_flops("bf16", "bwd_dq", d) == 4 * m + 6
    assert chip_smoke.wide_floor_flops("bf16", "bwd_dkv", d) == 4 * m + 12
    assert chip_smoke.wide_floor_flops("f32", "bwd_dq", d) == 3 * (4 * m + 2)
    assert chip_smoke.wide_floor_flops("f32", "bwd_dkv", d) == 3 * (4 * m + 4)
    if d == 512:
        entries = chip_smoke.causal_entries((8, 8, 2, 4096, 512))
        floor = {(key, kind): chip_smoke.wide_floor_flops(key, kind, d) * d * entries / rate * 1e3
                 for key, rate in (("bf16", chip_smoke.BF16_FLOPS),
                                   ("f32", chip_smoke.TF32_FLOPS))
                 for kind in ("bwd_dq", "bwd_dkv")}
        assert {k: round(v, 3) for k, v in floor.items()} == {
            ("bf16", "bwd_dq"): 22.235, ("bf16", "bwd_dkv"): 35.577,
            ("f32", "bwd_dq"): 79.967, ("f32", "bwd_dkv"): 106.623}


def test_smem_bytes_follow_the_plans_in_the_sources(tmp_path, monkeypatch):
    """``kernel_smem_bytes`` evaluates the plan structs of the sources: a
    copy of csrc/ with one more stage in the bf16 forward's plan gives one
    more staged K or V tile (128 x 128 bf16 at d = 128, 64 x 256 at
    d = 256: 32 768 bytes) and its two mbarriers, and nothing else moves."""
    from mpi_tpu_torch import _build

    for f in _build.SRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    cu = tmp_path / "attention.cu"
    text = cu.read_text()
    assert text.count("NS = D == 128 ? 6 : 5,") == 1
    cu.write_text(text.replace("NS = D == 128 ? 6 : 5,", "NS = D == 128 ? 7 : 6,"))
    before = {(d, dt): attention.kernel_smem_bytes(d, dt)
              for d in (128, 256) for dt in (torch.float32, torch.bfloat16)}
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    attention._plan_smem.cache_clear()
    try:
        for (d, dt), was in before.items():
            now = attention.kernel_smem_bytes(d, dt)
            grown = 32768 + 2 * 8 if dt == torch.bfloat16 else 0
            assert now == dict(was, fwd=was["fwd"] + grown), (d, dt)
    finally:
        attention._plan_smem.cache_clear()


def test_aligned_copies_only_a_view_off_16_bytes():
    """The kernels stage 16-byte chunks: a bf16 view that starts 8 bytes
    past an aligned address is copied, an aligned tensor is passed as is."""
    base = torch.arange(4 * 128 + 4, dtype=torch.float32).to(torch.bfloat16)
    view = base[4:].view(1, 4, 128)
    assert view.data_ptr() % 16 == 8
    got = attention._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    assert attention._aligned(got) is got


@pytest.mark.gpu
def test_forward_takes_a_bf16_view_off_16_bytes_on_card():
    """A contiguous bf16 Q/K/V view starting 8 bytes past a 16-byte
    boundary runs the forward (its 16-byte copies would fault on it) and
    agrees with the same values at an aligned address."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu on the card)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 8 * 2 * 48 * 128
    views = []
    for _ in range(3):
        base = torch.randn(n + 4, device="cuda", generator=gen).to(torch.bfloat16)
        views.append(base[4:].view(8, 2, 48, 128))
    assert all(t.data_ptr() % 16 == 8 for t in views)
    out, lse = attention.ring_attention_world(*views, causal=True, with_lse=True)
    want, wlse = attention.ring_attention_world(*(t.clone() for t in views), causal=True,
                                                with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(lse, wlse)


def test_wrapper_launches_or_raises_off_cpu():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches the kernel (CUDA) or raises (here: the meta device)."""
    m = torch.zeros(2, 8, 128, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        attention.ring_attention_world(m, m, m)
    with pytest.raises(RuntimeError, match="CUDA"):
        attention.ring_attention_bwd_world(m, m, m, m, torch.zeros(2, 1, 8, device="meta"), m)


def test_per_rank_call_outside_run_raises():
    from mpi_tpu_torch import SpmdContextError

    x = torch.zeros(8, 128)
    with pytest.raises(SpmdContextError, match="run_spmd"):
        attention.ring_attention(x, x, x, TorchCommunicator(2))
