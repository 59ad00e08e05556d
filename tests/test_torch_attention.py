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
])
def test_forward_plain_matches_pallas(P, hq, hkv, sb, d, dt, causal):
    q, k, v = blocks(P, hq, hkv, sb, d, seed=P * 100 + hq * 10 + hkv)
    want = jax_forward(q, k, v, dt, causal=causal)
    attention.reset_launches()
    got = port_forward(q, k, v, dt, causal=causal)
    np.testing.assert_allclose(got, want, **TOL[dt])
    assert attention.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


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


def test_kernel_plan_gives_the_byte_arithmetic():
    """Head dims the kernels are not built for raise with the numbers of
    the largest block (the float32 backward); d = 128 and 256 fit a block
    in both dtypes.  The bytes are read from the plans of csrc/attention.cu
    (``FwdBf16Plan``, ``FwdF32Plan``) and csrc/attention_bwd.cu, so these
    numbers pin the kernels' layout."""
    for d in (128, 256):
        attention._kernel_plan(d)
        for dt in (torch.float32, torch.bfloat16):
            assert max(attention.kernel_smem_bytes(d, dt).values()) <= attention._SMEM_LIMIT
    # the forward: Q tiles of three warpgroups at d = 128 (two for bf16 at
    # d = 256, one for float32), sharing the staged K/V tiles
    assert attention.kernel_smem_bytes(128, torch.bfloat16)["fwd"] == 132096
    assert attention.kernel_smem_bytes(256, torch.bfloat16)["fwd"] == 230400
    assert attention.kernel_smem_bytes(128)["fwd"] == 168960
    assert attention.kernel_smem_bytes(256)["fwd"] == 199680
    assert attention.kernel_smem_bytes(128, torch.bfloat16)["bwd_dkv"] == 100352
    assert attention.kernel_smem_bytes(256, torch.bfloat16)["bwd_dq"] == 198656
    assert attention.kernel_smem_bytes(128)["bwd_dq"] == 101632
    assert attention.kernel_smem_bytes(256)["bwd_dkv"] == 199936
    with pytest.raises(NotImplementedError, match="298240 bytes .* beyond"):
        attention._kernel_plan(384)
    with pytest.raises(NotImplementedError, match="beyond"):
        attention._kernel_plan(512)


def test_smem_bytes_follow_the_plans_in_the_sources(tmp_path, monkeypatch):
    """``kernel_smem_bytes`` evaluates the plan structs of the sources: a
    copy of csrc/ with one more staged V tile in the bf16 forward's plan
    gives one more 64 x d bf16 tile, and nothing else moves."""
    from mpi_tpu_torch import _build

    for f in _build.SRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    cu = tmp_path / "attention.cu"
    text = cu.read_text()
    assert text.count("(W + 2 + 3) * TILE") == 1
    cu.write_text(text.replace("(W + 2 + 3) * TILE", "(W + 2 + 4) * TILE"))
    before = {(d, dt): attention.kernel_smem_bytes(d, dt)
              for d in (128, 256) for dt in (torch.float32, torch.bfloat16)}
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    attention._plan_smem.cache_clear()
    try:
        for (d, dt), was in before.items():
            now = attention.kernel_smem_bytes(d, dt)
            grown = 64 * d * 2 if dt == torch.bfloat16 else 0
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
