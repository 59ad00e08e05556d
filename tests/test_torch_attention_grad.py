"""Gradients of the port's ring attention (mpi_tpu_torch/gpu/attention.py)
against ``jax.grad`` through the reference's fused backward
(pallas_attention.py ``_bwd_kernel`` in interpret mode), on the same numpy
inputs and cotangent.

The port's gradients are taken the way a user takes them: per rank with
``torch.func.grad`` inside ``mpi_tpu_torch.run(..., device="cpu")``, so the
backward goes through the world-level backward op and its plain version.

Tolerances: float32 ``rtol=1e-4, atol=1e-5`` (the backward sums several
products of dot products, each summed in its own order by XLA and by
PyTorch); bfloat16 gradients, compared as bfloat16 values, ``rtol=atol=2e-2``
(about two bfloat16 ulps).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as PS

from mpi_tpu.tpu import default_mesh
from mpi_tpu.tpu.pallas_attention import pallas_ring_attention
import mpi_tpu_torch
from mpi_tpu_torch import TorchCommunicator
from mpi_tpu_torch.gpu import attention
from mpi_tpu_torch.interop import to_numpy

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def inputs(P, hq, hkv, sb, d, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(P, hq, sb, d).astype(np.float32)
    k = rs.randn(P, hkv, sb, d).astype(np.float32)
    v = rs.randn(P, hkv, sb, d).astype(np.float32)
    ct = rs.randn(P, hq, sb, d).astype(np.float32)
    return q, k, v, ct


def jax_grads(q, k, v, ct, dt, causal):
    P, jdt = q.shape[0], DT[dt][0]

    def loss(qb, kb, vb, cb):
        out = pallas_ring_attention(qb, kb, vb, "world", P, causal=causal,
                                    interpret=True)
        return jnp.sum(out.astype(jnp.float32) * cb)

    def per_device(qb, kb, vb, cb):
        g = jax.grad(loss, argnums=(0, 1, 2))(qb[0], kb[0], vb[0], cb[0])
        return tuple(x[None] for x in g)

    jf = jax.jit(jax.shard_map(per_device, mesh=default_mesh(P),
                               in_specs=(PS("world"),) * 4,
                               out_specs=(PS("world"),) * 3, check_vma=False))
    g = jf(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(ct))
    return [np.asarray(x.astype(jnp.float32)) for x in g]


def port_grads(q, k, v, ct, dt, causal, comm=None):
    P, tdt = q.shape[0], DT[dt][1]
    comm = comm or TorchCommunicator(P)

    def prog(c, Q, K, V, C):
        def loss(qb, kb, vb):
            out = attention.ring_attention(qb, kb, vb, comm, causal=causal)
            return torch.sum(out.float() * C[c.rank])

        return torch.func.grad(loss, argnums=(0, 1, 2))(
            Q[c.rank], K[c.rank], V[c.rank])

    world = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    attention.reset_launches()
    g = mpi_tpu_torch.run(prog, *world, torch.from_numpy(ct), nranks=P,
                          device="cpu")
    assert attention.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    return [to_numpy(x) for x in g]


@pytest.mark.parametrize("P,hq,hkv,sb,dt,causal", [
    (4, 2, 2, 8, "f32", True),     # MHA
    (4, 4, 2, 8, "f32", False),    # GQA
    (4, 4, 1, 8, "f32", True),     # MQA
    (8, 1, 1, 8, "f32", True),     # the training example's shape, small
    (4, 4, 2, 16, "bf16", True),
])
def test_grads_match_pallas_fused_backward(P, hq, hkv, sb, dt, causal):
    q, k, v, ct = inputs(P, hq, hkv, sb, 128, seed=P + 10 * hq + hkv)
    want = jax_grads(q, k, v, ct, dt, causal)
    got = port_grads(q, k, v, ct, dt, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL[dt])
    assert all(np.abs(g).max() > 0 for g in got)


@pytest.mark.parametrize("P,hq,hkv,sb,d,dt,causal", [
    (2, 2, 1, 8, 384, "f32", True),      # MQA
    (2, 4, 2, 8, 512, "f32", False),     # GQA
    (2, 2, 2, 8, 512, "f32", True),
    (2, 2, 1, 16, 512, "bf16", True),
    (2, 2, 1, 8, 640, "f32", True),      # the float32 backward's cluster of 5
    (2, 4, 2, 8, 1152, "f32", False),    # clusters of 3 blocks, 3 passes each
])
def test_wide_grads_match_pallas_fused_backward(P, hq, hkv, sb, d, dt, causal):
    """Head dims above 256 (on the card: csrc/attention_bwd_wide.cu), with
    the tolerances above."""
    q, k, v, ct = inputs(P, hq, hkv, sb, d, seed=d + 10 * hq + hkv)
    want = jax_grads(q, k, v, ct, dt, causal)
    got = port_grads(q, k, v, ct, dt, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL[dt])
    assert all(np.abs(g).max() > 0 for g in got)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(causal):
    """The plain backward is the derivative of the plain forward: torch
    autograd through ``ring_attention_plain`` gives the same gradients,
    split groups and GQA included."""
    q, k, v, ct = (torch.from_numpy(a) for a in inputs(8, 4, 2, 8, 128, seed=21))
    groups = [[0, 1, 2, 3], [4, 5, 6, 7]]
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = attention.ring_attention_plain(qa, ka, va, groups, causal=causal)
    torch.sum(out * ct).backward()
    out2, lse = attention.ring_attention_plain(q, k, v, groups, causal=causal,
                                               with_lse=True)
    got = attention.ring_attention_bwd_plain(q, k, v, out2, lse, ct, groups,
                                             causal=causal)
    for g, w in zip(got, (qa.grad, ka.grad, va.grad)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_split_communicator_grads_equal_per_group_runs():
    """Under a split communicator each group's gradients are those of the
    group run alone on a world of its own."""
    q, k, v, ct = inputs(8, 2, 1, 8, 128, seed=4)
    sub = TorchCommunicator(8).split_by(lambda i: i % 2)
    got = port_grads(q, k, v, ct, "f32", True, comm=sub)
    for grp in ([0, 2, 4, 6], [1, 3, 5, 7]):
        alone = port_grads(q[grp], k[grp], v[grp], ct[grp], "f32", True)
        for g, w in zip(got, alone):
            np.testing.assert_allclose(g[grp], w, rtol=1e-6, atol=1e-6)


def test_single_head_grads_take_the_single_head_layout():
    q, k, v, ct = (a[:, 0] for a in inputs(4, 1, 1, 8, 128, seed=9))
    got = port_grads(q, k, v, ct, "f32", False)
    want = port_grads(q[:, None], k[:, None], v[:, None], ct[:, None], "f32",
                      False)
    for g, w in zip(got, want):
        assert g.shape == q.shape
        np.testing.assert_allclose(g, w[:, 0], rtol=0, atol=0)


def test_no_second_derivative():
    q, k, v, ct = inputs(2, 1, 1, 8, 128, seed=2)

    def prog(c, Q):
        def loss(qb):
            return attention.ring_attention(qb, qb, qb, c).sum()

        return torch.func.grad(
            lambda x: torch.func.grad(loss)(x).sum())(Q[c.rank])

    with pytest.raises(NotImplementedError, match="second derivative"):
        mpi_tpu_torch.run(prog, q[:, 0], nranks=2, device="cpu")
