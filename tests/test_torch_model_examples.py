"""The ported model examples (``mpi_tpu_torch/examples``: moe, pipeline,
ulysses_attention, data_parallel) against the JAX package on the CPU.

The reference programs draw their inputs with ``jax.random`` and the
port's with ``rank_normal`` (other streams), so the layer functions are
held to each other on the same inputs: numpy draws, and the reference
programs' own draws (recomputed here with ``jax.random`` and carried
across as numpy arrays, the weights through ``params_from_numpy``).

Tolerances (float32; XLA and torch sum matmuls in different orders):
layer against layer ``rtol=1e-5, atol=1e-6``; the 20-step data-parallel
run ``rtol=1e-5`` on the loss and checksum; layer against the float64
numpy oracles ``atol=1e-5`` (the reference tests' oracles use ``1e-4``).
"""

import numpy as np
import pytest

import jax
import torch

import mpi_tpu_torch
from examples import data_parallel as jdp
from examples import moe as jmoe
from examples import pipeline as jpipe
from examples import ulysses_attention as jul
from mpi_tpu.tpu import run_spmd
from mpi_tpu_torch import params_from_numpy
from mpi_tpu_torch.examples import data_parallel as tdp
from mpi_tpu_torch.examples import moe as tmoe
from mpi_tpu_torch.examples import pipeline as tpipe
from mpi_tpu_torch.examples import ulysses_attention as tul

P = 4
RTOL, ATOL = 1e-5, 1e-6


def trun(prog, *args, nranks=P, **kw):
    out = mpi_tpu_torch.run(prog, *args, nranks=nranks, device="cpu", **kw)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def jrun(prog, *args, nranks=P, **kw):
    out = run_spmd(prog, *args, nranks=nranks, **kw)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def key(seed, *folds):
    k = jax.random.PRNGKey(seed)
    for f in folds:
        k = jax.random.fold_in(k, f)
    return k


# -- MoE --------------------------------------------------------------------------


def moe_fixtures(T=12, D=6, F=10, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(P, T, D).astype(np.float32)
    w_router = rng.randn(D, P).astype(np.float32)
    w_in = (rng.randn(P, D, F) * 0.3).astype(np.float32)
    w_out = (rng.randn(P, F, D) * 0.3).astype(np.float32)
    return x, w_router, w_in, w_out


def both_moe(x, w_router, w_in, w_out, capacity):
    got = trun(lambda c, x, wr, wi, wo: tmoe.moe_layer(
        c, x[c.rank], wr, wi[c.rank], wo[c.rank], capacity), x, w_router, w_in, w_out)
    want = jrun(lambda c, x, wr, wi, wo: jmoe.moe_layer(
        c, x[c.rank], wr, wi[c.rank], wo[c.rank], capacity), x, w_router, w_in, w_out)
    return got, want


@pytest.mark.parametrize("capacity", [5, 12])
def test_moe_layer_matches_reference_and_oracle(capacity):
    args = moe_fixtures()
    got, want = both_moe(*args, capacity)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    oracle = tmoe.moe_oracle(*args, capacity)
    np.testing.assert_allclose(got, oracle, atol=1e-5)
    np.testing.assert_allclose(oracle, jmoe.moe_oracle(*args, capacity), atol=1e-5)


def test_moe_capacity_drops_tokens():
    """tests/test_moe_pipeline.py:48: with capacity 1 at most one token per
    (source, expert) survives, so more outputs are zero than at 5."""
    args = moe_fixtures(seed=1)
    got, want = both_moe(*args, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, tmoe.moe_oracle(*args, 1), atol=1e-5)
    full, _ = both_moe(*args, 5)
    assert (np.abs(got) < 1e-9).sum() > (np.abs(full) < 1e-9).sum()


def test_moe_reference_program_draws():
    """The reference's moe_program, and the port's layer on its draws."""
    T, D, F, C = 16, 8, 16, 8
    x = np.stack([np.array(jax.random.normal(key(5, r), (T, D))) for r in range(P)])
    wr = np.array(jax.random.normal(key(5, 1000), (D, P)))
    wi = np.stack([np.array(jax.random.normal(key(5, 2000 + r), (D, F)) * 0.3)
                   for r in range(P)])
    wo = np.stack([np.array(jax.random.normal(key(5, 3000 + r), (F, D)) * 0.3)
                   for r in range(P)])
    want = jrun(jmoe.moe_program)
    got, _ = both_moe(x, wr, wi, wo, C)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_moe_program_matches_oracle_on_its_draws():
    out = trun(tmoe.moe_program, nranks=8)
    x, wr, wi, wo = trun(tmoe.moe_inputs, nranks=8)
    assert np.array_equal(wr[0], wr[-1])  # the router is replicated
    np.testing.assert_allclose(out, tmoe.moe_oracle(x, wr[0], wi, wo, 8), atol=1e-5)


# -- pipeline ---------------------------------------------------------------------


def pipe_both(micro_x, ws, bs):
    def tprog(c, mx, w, b):
        return tpipe.pipeline_forward(c, mx, w[c.rank], b[c.rank])

    def jprog(c, mx, w, b):
        return jpipe.pipeline_forward(c, mx, w[c.rank], b[c.rank])

    return trun(tprog, micro_x, ws, bs), jrun(jprog, micro_x, ws, bs)


def test_pipeline_forward_matches_reference_and_oracle():
    rng = np.random.RandomState(2)
    micro_x = rng.randn(6, 3, 5).astype(np.float32)
    ws = (rng.randn(P, 5, 5) * 0.5).astype(np.float32)
    bs = (rng.randn(P, 5) * 0.1).astype(np.float32)
    got, want = pipe_both(micro_x, ws, bs)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:-1], 0.0)  # only the last stage holds outputs
    oracle = tpipe.pipeline_oracle(micro_x, ws, bs)
    np.testing.assert_allclose(got[-1], oracle, atol=1e-5)
    np.testing.assert_allclose(oracle, jpipe.pipeline_oracle(micro_x, list(ws), list(bs)),
                               atol=1e-5)


def test_pipeline_reference_program_draws():
    M, B, D = 6, 4, 8
    micro_x = np.array(jax.random.normal(key(7, 999), (M, B, D)))
    ws = np.stack([np.array(jax.random.normal(key(7, r), (D, D)) * 0.5)
                   for r in range(P)])
    bs = np.stack([np.array(jax.random.normal(key(7, 100 + r), (D,)) * 0.1)
                   for r in range(P)])
    got, _ = pipe_both(micro_x, ws, bs)
    np.testing.assert_allclose(got, jrun(jpipe.pipeline_program), rtol=RTOL, atol=ATOL)


def test_pipeline_program_matches_oracle_on_its_draws():
    out = trun(tpipe.pipeline_program, nranks=8)
    micro_x, ws, bs = trun(tpipe.pipeline_inputs, nranks=8)
    np.testing.assert_allclose(out[-1], tpipe.pipeline_oracle(micro_x[0], ws, bs),
                               atol=1e-5)


# -- Ulysses ----------------------------------------------------------------------


def dense_attention(q, k, v):
    s = np.einsum("shd,thd->hst", q, k) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("hst,thd->shd", p / p.sum(-1, keepdims=True), v)


def test_ulysses_attention_matches_reference():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(P, 8, 8, 16).astype(np.float32) for _ in range(3))
    got = trun(lambda c, q, k, v: tul.ulysses_attention(c, q[c.rank], k[c.rank],
                                                        v[c.rank]), q, k, v)
    want = jrun(lambda c, q, k, v: jul.ulysses_attention(c, q[c.rank], k[c.rank],
                                                         v[c.rank]), q, k, v)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    whole = lambda t: np.concatenate(list(t.astype(np.float64)))
    np.testing.assert_allclose(whole(got), dense_attention(whole(q), whole(k), whole(v)),
                               atol=1e-5)


def test_ulysses_reference_program_draws():
    s, H, d = 32, 8, 16
    qkv = [[np.array(jax.random.normal(kk, (s, H, d)))
            for kk in jax.random.split(key(11, r), 3)] for r in range(P)]
    q, k, v = (np.stack([qkv[r][i] for r in range(P)]) for i in range(3))
    want = jrun(jul.ulysses_program)
    np.testing.assert_array_equal(want[1], q)  # the draws recomputed here
    got = trun(lambda c, q, k, v: tul.ulysses_attention(c, q[c.rank], k[c.rank],
                                                        v[c.rank]), q, k, v)
    np.testing.assert_allclose(got, want[0], rtol=RTOL, atol=ATOL)


def test_ulysses_program_matches_dense_attention():
    out, q, k, v = trun(tul.ulysses_program, nranks=8)
    whole = lambda t: np.concatenate(list(t.astype(np.float64)))
    np.testing.assert_allclose(whole(out), dense_attention(whole(q), whole(k), whole(v)),
                               atol=1e-5)


def test_ulysses_rejects_indivisible_heads():
    """tests/test_long_context.py:92."""
    with pytest.raises(ValueError, match="divisible"):
        trun(lambda c: tul.ulysses_attention(c, *(torch.zeros((4, 6, 2)),) * 3))


# -- data parallel ----------------------------------------------------------------


def reference_dp_draws(batch=32, d_in=8, d_hidden=16):
    """The initial weights and per-rank data of examples/data_parallel.py."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"w1": np.array(jax.random.normal(k1, (d_in, d_hidden)) * 0.3),
              "w2": np.array(jax.random.normal(k2, (d_hidden, 1)) * 0.3)}
    x = np.stack([np.array(jax.random.normal(key(1, r), (batch, d_in)))
                  for r in range(P)])
    return params, x, np.sin(x.sum(axis=2, keepdims=True))


def test_dp_loop_matches_reference_program():
    params, x, y = reference_dp_draws()
    want_loss, want_ck = jrun(jdp.dp_train_program)

    def prog(c, params, x, y):
        return tdp.dp_train(c, params, x[c.rank], y[c.rank], steps=20, lr=0.05)

    loss, ck = trun(prog, params_from_numpy(params, "cpu"), x, y)
    np.testing.assert_allclose(loss, np.ravel(want_loss), rtol=RTOL)
    np.testing.assert_allclose(ck, np.ravel(want_ck), rtol=RTOL)


def test_dp_program_loss_decreases():
    one, _ = trun(tdp.dp_train_program, nranks=8, steps=1)
    many, ck = trun(tdp.dp_train_program, nranks=8, steps=20)
    assert many[0] < one[0]
    assert np.all(many == many[0]) and np.all(ck == ck[0])  # replicated
