"""The ported long-context examples (mpi_tpu_torch/examples/ring_attention.py
and long_context_training.py) against dense one-device oracles and against
the JAX examples, on the CPU.

Tolerances: the ring-attention programs against a dense numpy softmax as
``tests/test_long_context.py`` holds the reference (``rtol=2e-4,
atol=2e-5``); the training step as ``tests/test_long_context.py:180-185``
(loss ``rtol=1e-5, atol=1e-6``, gradients ``rtol=5e-4, atol=5e-5``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as PS

import mpi_tpu_torch
from mpi_tpu_torch.examples import long_context_training as port_lct
from mpi_tpu_torch.examples.ring_attention import ring_attention_program
from mpi_tpu_torch.gpu import attention
from mpi_tpu_torch.interop import params_from_numpy, to_numpy


def dense_oracle(q, k, v, causal):
    s = (q @ k.T) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones(s.shape, bool)), s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return p @ v


@pytest.mark.parametrize("kernel,d", [(False, 32), (True, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_program_matches_dense_oracle(kernel, d, causal):
    P, s = 4, 16
    out, q, k, v = (to_numpy(t) for t in mpi_tpu_torch.run(
        ring_attention_program, nranks=P, device="cpu", seq_per_rank=s, d=d,
        kernel=kernel, causal=causal))
    flat = [a.reshape(P * s, d) for a in (out, q, k, v)]
    np.testing.assert_allclose(flat[0], dense_oracle(*flat[1:], causal),
                               rtol=2e-4, atol=2e-5)


def _multihead_program(comm, s, d, hq, hkv):
    q = mpi_tpu_torch.rank_normal((hq, s, d), 7)
    k, v = (mpi_tpu_torch.rank_normal((hkv, s, d), seed) for seed in (8, 9))
    return attention.ring_attention(q, k, v, comm, causal=True), q, k, v


def test_multihead_program_matches_dense_oracle_per_head():
    """The fused ring attention with GQA heads inside ``run``: query head h
    against K/V head h // 2 over the whole sequence."""
    P, s, d, hq, hkv = 4, 16, 128, 4, 2
    out, q, k, v = (to_numpy(t) for t in mpi_tpu_torch.run(
        _multihead_program, s, d, hq, hkv, nranks=P, device="cpu"))
    glob = [a.transpose(1, 0, 2, 3).reshape(a.shape[1], P * s, d)
            for a in (out, q, k, v)]
    for h in range(hq):
        np.testing.assert_allclose(
            glob[0][h], dense_oracle(glob[1][h], glob[2][h // 2],
                                     glob[3][h // 2], True),
            rtol=2e-4, atol=2e-5)


def test_ranks_draw_different_blocks():
    out, q, k, v = mpi_tpu_torch.run(ring_attention_program, nranks=2,
                                     device="cpu", seq_per_rank=8, d=4)
    assert not torch.equal(q[0], q[1]) and not torch.equal(q, k)


def test_init_params_are_the_references():
    from examples.long_context_training import init_params

    want = init_params(128, 256, seed=3)
    got = port_lct.init_params(128, 256, seed=3)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]))


def _jax_sharded_step(params, x, y, P):
    from examples.long_context_training import sharded_train_step
    from mpi_tpu.tpu import default_mesh

    jstep = jax.jit(jax.shard_map(
        sharded_train_step(P, interpret=True), mesh=default_mesh(P, axis_name="sp"),
        in_specs=(PS(), PS("sp"), PS("sp")), out_specs=(PS(), PS()),
        check_vma=False))
    loss, grads = jstep({n: jnp.asarray(a) for n, a in params.items()},
                        jnp.asarray(x), jnp.asarray(y))
    return float(loss), {n: np.asarray(g) for n, g in grads.items()}


def test_training_step_matches_jax_step_and_dense_oracle():
    """One training step at P=8, s=16, d=128 with the JAX example's
    weights carried across: the port's sharded step (ring attention
    forward and backward) agrees with the JAX sharded step on the fused
    Pallas kernels and with the port's dense one-device step."""
    from examples.long_context_training import init_params

    P, s, d = 8, 16, 128
    S = P * s
    rng = np.random.RandomState(2)
    x = rng.randn(S, d).astype(np.float32)
    y = rng.randn(S, d).astype(np.float32)
    jparams = {n: np.asarray(a) for n, a in init_params(d, 2 * d).items()}
    loss_j, grads_j = _jax_sharded_step(jparams, x, y, P)

    block = port_lct.TransformerBlock(d, 2 * d)
    block.load_state_dict(params_from_numpy(jparams, "cpu"))
    params = {n: p.detach() for n, p in block.named_parameters()}
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    attention.reset_launches()
    loss_s, grads_s = mpi_tpu_torch.run(port_lct.sharded_program, block,
                                        params, xt, yt, nranks=P, device="cpu")
    assert attention.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    loss_d, grads_d = port_lct.dense_train_step(block)(params, xt, yt)

    assert torch.equal(loss_s, loss_s[:1].expand_as(loss_s))
    for want in (loss_j, float(loss_d)):
        np.testing.assert_allclose(float(loss_s[0]), want, rtol=1e-5, atol=1e-6)
    for name in grads_j:
        g = grads_s[name].numpy()
        assert np.array_equal(g[0], g[-1]), name  # every rank holds the mean
        for want in (grads_j[name], grads_d[name].numpy()):
            np.testing.assert_allclose(g[0], want, rtol=5e-4, atol=5e-5,
                                       err_msg=name)


def test_training_main_runs_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["long_context_training", "-n", "4",
                                     "--seq-per-rank", "8", "--steps", "2",
                                     "--device", "cpu"])
    port_lct.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("step 0: loss=")
    l0, l1 = (float(line.split("loss=")[1].split()[0]) for line in lines)
    assert l1 < l0  # a step of gradient descent lowers the loss


def test_ring_attention_main_runs_on_cpu(capsys, monkeypatch):
    from mpi_tpu_torch.examples import ring_attention as ex

    monkeypatch.setattr("sys.argv", ["ring_attention", "-n", "4", "--kernel",
                                     "--dim", "128", "--seq-per-rank", "16",
                                     "--causal", "--device", "cpu"])
    ex.main()
    assert "ring attention OK: local block (16, 128)" in capsys.readouterr().out


@pytest.mark.gpu
def test_attention_kernels_match_plain_on_card():
    """The CUDA kernels against the plain versions on the card, with the
    tolerances of chip_smoke.py: float32 ``rtol=1e-4, atol=1e-5``;
    bfloat16 the same plus 2^-7 of |plain| (each side rounds a float32
    result to bfloat16 once, so they differ by at most one bfloat16 ulp
    beyond the float32 difference)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu on the card)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-4 + 2.0 ** -7)):
        for hq, hkv in ((4, 4), (4, 1)):
            for causal in (False, True):
                q = torch.randn(8, hq, 48, 128, device="cuda", generator=gen).to(dt)
                k, v = (torch.randn(8, hkv, 48, 128, device="cuda",
                                    generator=gen).to(dt) for _ in range(2))
                do = torch.randn(q.shape, device="cuda", generator=gen).to(dt)
                out, lse = attention.ring_attention_world(q, k, v, causal=causal,
                                                          with_lse=True)
                want, wlse = attention.ring_attention_plain(q, k, v, causal=causal,
                                                            with_lse=True)
                got = attention.ring_attention_bwd_world(q, k, v, want, wlse, do,
                                                         causal=causal)
                ref = attention.ring_attention_bwd_plain(q, k, v, want, wlse, do,
                                                         causal=causal)
                for a, b in zip((out, *got), (want, *ref)):
                    torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                               atol=1e-5)
