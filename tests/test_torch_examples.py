"""The port's example programs and entry point against the JAX package's and
a serial numpy oracle (tolerances of tests/test_examples_parity.py:42).

pi: the two packages draw different random streams (``jax.random`` vs a
per-rank ``torch.Generator``), so the reduction is compared on identical
per-rank hit counts and the port's own estimate is checked statistically.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import mpi_tpu_torch
from examples.jacobi import jacobi_program as jax_jacobi
from mpi_tpu import ops as jops
from mpi_tpu.tpu import run_spmd
from mpi_tpu_torch import ops as tops
from mpi_tpu_torch.entry import entry as torch_entry
from mpi_tpu_torch.examples.jacobi import jacobi_program, jacobi_step
from mpi_tpu_torch.examples.pi import pi_program

NR = 4


def _serial_jacobi(nrows, cols, iters):
    grid = np.zeros((nrows + 2, cols), np.float32)
    grid[0] = 1.0
    cur = grid.copy()
    for _ in range(iters):
        new = cur.copy()
        inner = 0.25 * (cur[:-2] + cur[2:]
                        + np.pad(cur[1:-1, :-1], ((0, 0), (1, 0)))
                        + np.pad(cur[1:-1, 1:], ((0, 0), (0, 1))))
        inner[:, 0] = 0.0
        inner[:, -1] = 0.0
        new[1:-1] = inner
        prev, cur = cur, new
    return cur[1:-1], np.max(np.abs(cur[1:-1] - prev[1:-1]))


@pytest.mark.parametrize("nranks,rows,cols,iters", [(4, 4, 16, 40), (8, 3, 10, 25)])
def test_jacobi_torch_vs_jax_vs_serial(nranks, rows, cols, iters):
    blocks_t, res_t = mpi_tpu_torch.run(jacobi_program, nranks=nranks, device="cpu",
                                        rows_per_rank=rows, cols=cols, iters=iters)
    blocks_t = blocks_t.numpy().reshape(nranks * rows, cols)
    blocks_j, res_j = run_spmd(jax_jacobi, nranks=nranks, rows_per_rank=rows,
                               cols=cols, iters=iters)
    blocks_j = np.asarray(blocks_j).reshape(nranks * rows, cols)
    oracle, oracle_res = _serial_jacobi(nranks * rows, cols, iters)
    np.testing.assert_allclose(blocks_t, blocks_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(blocks_t, oracle, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(res_t[0]), float(np.asarray(res_j).ravel()[0]), rtol=1e-4)
    np.testing.assert_allclose(float(res_t[0]), oracle_res, rtol=1e-3, atol=1e-7)
    assert torch.equal(res_t, res_t[:1].expand_as(res_t))


def test_entry_matches_jax_entry():
    import __graft_entry__

    grid = np.random.RandomState(0).rand(64, 128).astype(np.float32)
    jf, (jex,) = __graft_entry__.entry()
    jnew, jres = jf(jnp.asarray(grid))
    tf, (tex,) = torch_entry(device="cpu")
    assert tuple(tex.shape) == tuple(jex.shape) and tex.dtype == torch.float32
    tnew, tres = tf(torch.from_numpy(grid))
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tres), float(np.asarray(jres)), rtol=1e-5)


def test_entry_split_over_ranks_matches_one_rank():
    grid = torch.from_numpy(np.random.RandomState(1).rand(64, 128).astype(np.float32))
    f1, _ = torch_entry(nranks=1, device="cpu")
    f4, _ = torch_entry(nranks=4, device="cpu")
    new1, res1 = f1(grid)
    new4, res4 = f4(grid)
    # one step of the decomposed stencil equals the undecomposed one
    np.testing.assert_array_equal(new4.numpy(), new1.numpy())
    assert float(res4) == float(res1)
    # ... and the rank-local step equals jacobi_step on the whole grid
    direct = mpi_tpu_torch.run(lambda c, g: jacobi_step(c, g), grid, nranks=1,
                               device="cpu")[0]
    np.testing.assert_array_equal(new1.numpy(), direct.numpy())


def test_pi_reduction_on_identical_hits():
    n = 5000
    hits = np.random.RandomState(2).randint(3500, 4100, size=NR).astype(np.float32)

    def jprog(comm, h):
        total = comm.allreduce(h[comm.rank], op=jops.SUM)
        return total, 4.0 * total / (n * comm.size)

    def tprog(comm, h):
        total = comm.allreduce(h[comm.rank], op=tops.SUM)
        return total, 4.0 * total / (n * comm.size)

    jtotal, jest = run_spmd(jprog, hits, nranks=NR)
    ttotal, test_ = mpi_tpu_torch.run(tprog, hits, nranks=NR, device="cpu")
    # integer-valued counts sum exactly; the final division may round
    # differently in XLA (rtol 1e-6, as tests/test_examples_parity.py)
    np.testing.assert_array_equal(ttotal.numpy(), np.asarray(jtotal))
    np.testing.assert_allclose(test_.numpy(), np.asarray(jest), rtol=1e-6)


def test_pi_estimate_statistics():
    n = 20_000
    est = mpi_tpu_torch.run(pi_program, nranks=NR, device="cpu", n_per_rank=n)
    assert est.shape == (NR,) and torch.equal(est, est[:1].expand(NR))
    # binomial std of the estimate: sqrt(pi*(4-pi)/(NR*n)) ~ 0.0058
    assert abs(float(est[0]) - np.pi) < 0.05
    again = mpi_tpu_torch.run(pi_program, nranks=NR, device="cpu", n_per_rank=n)
    assert torch.equal(est, again)  # per-rank generators are seeded
    other = mpi_tpu_torch.run(pi_program, nranks=NR, device="cpu", n_per_rank=n, seed=7)
    assert not torch.equal(est, other)
