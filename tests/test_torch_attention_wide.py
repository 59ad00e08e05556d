"""Ring attention at head dims above 256 (on the card the forms of
mpi_tpu_torch/csrc/attention_wide.cu and attention_bwd_wide.cu), as a user
reaches it: per-rank programs through ``mpi_tpu_torch.run(...,
device="cpu")`` against the JAX package's results on the same numpy inputs,
and one long-context training step at d = 512 with the reference's weights
carried across.

Tolerances as ``tests/test_torch_attention.py`` (float32 ``rtol=atol=1e-5``)
and ``tests/test_long_context.py:180-185`` (loss ``rtol=1e-5, atol=1e-6``,
gradients ``rtol=5e-4, atol=5e-5``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as PS

import mpi_tpu_torch
from mpi_tpu.tpu import default_mesh
from mpi_tpu.tpu.pallas_attention import pallas_ring_attention
from mpi_tpu_torch import TorchCommunicator
from mpi_tpu_torch.examples import long_context_training as port_lct
from mpi_tpu_torch.gpu import attention
from mpi_tpu_torch.interop import to_numpy

from test_torch_attention import TOL, blocks
from test_torch_long_context import _jax_sharded_step


def _reference_per_rank(q, k, v, causal):
    """Each rank's output of ``pallas_ring_attention(interpret=True)`` over
    a 1-D mesh of ``q.shape[0]`` devices."""
    P = q.shape[0]

    def f(qb, kb, vb):
        return pallas_ring_attention(qb[0], kb[0], vb[0], "world", P, causal=causal,
                                     interpret=True)[None]

    jf = jax.jit(jax.shard_map(f, mesh=default_mesh(P), in_specs=(PS("world"),) * 3,
                               out_specs=PS("world"), check_vma=False))
    return np.asarray(jf(*(jnp.asarray(a) for a in (q, k, v))))


@pytest.mark.parametrize("causal", [False, True])
def test_per_rank_program_at_d512_matches_reference(causal):
    """A program calling ``ring_attention`` on each rank's [Hq, Sb, 512]
    block (GQA 4/2) through ``run``: every rank's output is the reference's
    for that rank, and no kernel launched on the CPU."""
    q, k, v = blocks(4, 4, 2, 8, 512, seed=512 + causal)
    want = _reference_per_rank(q, k, v, causal)
    attention.reset_launches()
    got = mpi_tpu_torch.run(
        lambda c, a, b, e: attention.ring_attention(a[c.rank], b[c.rank], e[c.rank], c,
                                                    causal=causal),
        *(torch.from_numpy(a) for a in (q, k, v)), nranks=4, device="cpu")
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(to_numpy(got), want, **TOL["f32"])
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


def test_training_step_at_d512_matches_jax_step_and_dense_oracle():
    """One step of the long-context block at d = 512 (P = 4, 8 rows a rank):
    the reference's numpy weights go through ``block_from_numpy``; the
    port's sharded step (ring attention forward and backward at d = 512)
    agrees with the JAX sharded step on the fused Pallas kernels and with
    the port's dense one-device step."""
    from examples.long_context_training import init_params

    P, s, d = 4, 8, 512
    S = P * s
    rng = np.random.RandomState(5)
    x = rng.randn(S, d).astype(np.float32)
    y = rng.randn(S, d).astype(np.float32)
    jparams = {n: np.asarray(a) for n, a in init_params(d, 2 * d).items()}
    loss_j, grads_j = _jax_sharded_step(jparams, x, y, P)

    block = port_lct.block_from_numpy(jparams, "cpu")
    params = {n: p.detach() for n, p in block.named_parameters()}
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    attention.reset_launches()
    loss_s, grads_s = mpi_tpu_torch.run(port_lct.sharded_program, block, params, xt, yt,
                                        nranks=P, device="cpu")
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    loss_d, grads_d = port_lct.dense_train_step(block)(params, xt, yt)

    for want in (loss_j, float(loss_d)):
        np.testing.assert_allclose(float(loss_s[0]), want, rtol=1e-5, atol=1e-6)
    for name in grads_j:
        g = grads_s[name].numpy()
        assert np.array_equal(g[0], g[-1]), name
        for want in (grads_j[name], grads_d[name].numpy()):
            np.testing.assert_allclose(g[0], want, rtol=5e-4, atol=5e-5, err_msg=name)


def test_split_communicator_at_d384_equals_per_group_runs():
    """Two groups of interleaved ranks at d = 384: each group's output is
    that of the group run alone."""
    q, k, v = (torch.from_numpy(a) for a in blocks(8, 2, 1, 8, 384, seed=384))
    sub = TorchCommunicator(8).split_by(lambda i: i % 2)
    got = mpi_tpu_torch.run(
        lambda c, a, b, e: attention.ring_attention(a[c.rank], b[c.rank], e[c.rank], sub,
                                                    causal=True),
        q, k, v, nranks=8, device="cpu")
    for grp in ([0, 2, 4, 6], [1, 3, 5, 7]):
        alone = attention.ring_attention_world(q[grp], k[grp], v[grp], causal=True)
        torch.testing.assert_close(got[grp], alone, rtol=0, atol=0)


def test_wide_world_off_cpu_raises_and_never_falls_back():
    """A d = 512 world that is not on the CPU never takes the plain version:
    the wrapper launches the wide kernel (CUDA) or raises (here: meta)."""
    m = torch.zeros(2, 2, 8, 512, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        attention.ring_attention_world(m, m, m)
    with pytest.raises(RuntimeError, match="CUDA"):
        attention.bwd_operands(m, m, m, m, torch.zeros(2, 2, 8, device="meta"), m)


@pytest.mark.parametrize("name,dtype", [
    pytest.param("bwd_dq", torch.float32, id="bwd_dq-float32"),
    pytest.param("bwd_dkv", torch.float32, id="bwd_dkv-float32"),
    pytest.param("fwd", torch.float32, id="fwd-float32"),
    pytest.param("bwd_dq", torch.bfloat16, id="bwd_dq-bfloat16"),
    pytest.param("bwd_dkv", torch.bfloat16, id="bwd_dkv-bfloat16"),
    pytest.param("fwd", torch.bfloat16, id="fwd-bfloat16")])
def test_wide_refused_cluster_launch_raises_and_never_falls_back(name, dtype, monkeypatch):
    """A launch above d = 256 (the forward and both backward kernels run in
    thread-block clusters, in both dtypes) that the card refuses (no room
    for one cluster: ring_attention.cuh's kNoCluster) or whose source does
    not build raises with the reason; it is not counted, and neither the
    plain version nor another form runs in its place."""
    _refused_cluster_launch(name, dtype, monkeypatch)


def _refused_cluster_launch(name, dtype, monkeypatch):
    from mpi_tpu_torch import _build

    entry = "attn_fwd_wide" if name == "fwd" else f"attn_{name}_wide"
    source = "attention_wide" if name == "fwd" else "attention_bwd_wide"

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a launch path")

    class Refusing:
        def __getattr__(self, fn):
            assert fn == entry, fn
            return lambda *args: 1001

    monkeypatch.setattr(attention, "ring_attention_plain", plain)
    monkeypatch.setattr(attention, "ring_attention_bwd_plain", plain)
    monkeypatch.setattr(attention.torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    monkeypatch.setattr(attention, "_stream", lambda t: 0)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in blocks(2, 2, 1, 8, 512, seed=5))
    if name == "fwd":
        launch = lambda: attention._launch_fwd(q, k, v, [0, 1], 2, 0.5, True)  # noqa: E731
    else:
        lse, delta = torch.zeros(2, 2, 8), torch.zeros(2, 2, 8)
        outs = ((torch.empty_like(q),) if name == "bwd_dq" else
                (torch.empty_like(k), torch.empty_like(k)))
        launch = lambda: attention._launch_bwd(  # noqa: E731
            name, q, k, v, q, lse, delta, [0, 1], 2, 0.5, True, outs)
    attention.reset_launches()
    monkeypatch.setattr(_build, "load", lambda source: Refusing())
    with pytest.raises(RuntimeError, match=r"cluster launch was refused: "
                                           r"cudaOccupancyMaxActiveClusters .* \(code 1001\)"):
        launch()

    def unbuilt(source):
        raise RuntimeError(f"nvcc failed for csrc/{source}.cu (exit 1)")

    monkeypatch.setattr(_build, "load", unbuilt)
    with pytest.raises(RuntimeError, match=rf"nvcc failed for csrc/{source}.cu"):
        launch()
    assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    assert attention.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
