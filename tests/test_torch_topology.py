"""Process topologies (``mpi_tpu_torch.topology``) and the ported 2-D Jacobi
(``examples/jacobi2d.py``) against the JAX package on the CPU: the cases of
tests/test_topology.py:129, 145, 201, 221, 425 and 452, through both
packages on the same inputs.

Tolerances: exchanges, splits and neighbor collectives move values, so
they are compared exactly; the two Jacobi sweeps add the same terms in the
same order, and are held to each other at rtol 1e-6 and to the numpy
oracle at the reference test's atol 1e-5.
"""

import numpy as np
import pytest

import torch

import mpi_tpu_torch
from examples.jacobi2d import jacobi2d_program as jax_jacobi2d
from mpi_tpu import cart_create as jcart_create
from mpi_tpu import dims_create as jdims_create
from mpi_tpu.topology import graph_create as jgraph_create
from mpi_tpu.tpu import TpuCommunicator, default_mesh, run_spmd
from mpi_tpu_torch import TorchCommunicator, cart_create, dims_create, graph_create
from mpi_tpu_torch.examples.jacobi import jacobi_program
from mpi_tpu_torch.examples.jacobi2d import jacobi2d_program

P = 8


def trun(prog, *args, **kw):
    out = mpi_tpu_torch.run(prog, *args, nranks=kw.pop("nranks", P),
                            device="cpu", **kw)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


@pytest.mark.parametrize("n,nd", [(8, 2), (8, 3), (12, 2), (7, 2), (1, 3), (360, 3)])
def test_dims_create_matches_reference(n, nd):
    assert dims_create(n, nd) == jdims_create(n, nd)


def test_cart_exchange():
    """tests/test_topology.py:129."""
    def tprog(comm):
        cart = cart_create(comm, (2, 4))
        r = comm.rank.to(torch.float32)
        return cart.exchange(r, dim=1, disp=1, fill=-1.0), \
            cart.exchange(r, dim=0, disp=1, fill=-2.0)

    def jprog(comm, _):
        cart = jcart_create(comm, (2, 4))
        r = comm.rank.astype(np.float32)
        return cart.exchange(r, dim=1, disp=1, fill=-1.0), \
            cart.exchange(r, dim=0, disp=1, fill=-2.0)

    got = trun(tprog)
    want = run_spmd(jprog, np.zeros(1, np.float32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ravel(), np.ravel(np.asarray(w)))
    left, above = got
    for r in range(P):
        row, col = divmod(r, 4)
        assert left[r] == (r - 1 if col > 0 else -1.0)
        assert above[r] == (r - 4 if row > 0 else -2.0)


def test_cart_sub():
    """tests/test_topology.py:145."""
    def prog(comm):
        rows = cart_create(comm, (2, 4)).sub([False, True])
        return rows.comm.allreduce(comm.rank.to(torch.float32))

    out = trun(prog)
    assert list(out[:4]) == [0 + 1 + 2 + 3] * 4
    assert list(out[4:]) == [4 + 5 + 6 + 7] * 4


def test_cart_neighbor_collectives_periodic():
    def prog(comm):
        cart = cart_create(comm, (2, 4), periods=(True, False))
        r = comm.rank.to(torch.float32)
        got = cart.neighbor_allgather(r, fill=-1.0)
        sent = cart.neighbor_alltoall([r * 10 + k for k in range(4)], fill=-1.0)
        return torch.stack(got), torch.stack(sent)

    got, sent = trun(prog)
    for r in range(P):
        row, col = divmod(r, 4)
        up, down = 4 * ((row - 1) % 2) + col, 4 * ((row + 1) % 2) + col
        left = r - 1 if col > 0 else -1.0
        right = r + 1 if col < 3 else -1.0
        np.testing.assert_array_equal(got[r], [up, down, left, right])
        # the item a neighbor addresses to me: its +dim item from below me
        # in dim order, its -dim item from above
        np.testing.assert_array_equal(sent[r], [
            up * 10 + 1, down * 10 + 0,
            -1.0 if col == 0 else left * 10 + 3,
            -1.0 if col == 3 else right * 10 + 2])


def test_cart_shift_inside_program_raises():
    def prog(comm):
        cart = cart_create(comm, (2, 4))
        with pytest.raises(TypeError, match="traced"):
            cart.shift(0, 1)
        assert cart.shift_perm(1, 1) == jcart_create(
            TpuCommunicator("world", default_mesh()), (2, 4)).shift_perm(1, 1)
        return comm.rank

    trun(prog)


def oracle_jacobi(rows, cols, iters):
    """tests/test_topology.py:164: the same boundary problem, serially."""
    g = np.zeros((rows, cols), np.float32)
    prev = g
    for _ in range(iters):
        padded = np.zeros((rows + 2, cols + 2), np.float32)
        padded[1:-1, 1:-1] = g
        padded[0, 1:-1] = 1.0  # hot top edge
        new = 0.25 * (padded[:-2, 1:-1] + padded[2:, 1:-1]
                      + padded[1:-1, :-2] + padded[1:-1, 2:])
        new[:, 0] = 0.0
        new[:, -1] = 0.0
        g, prev = new.astype(np.float32), g
    return g, np.abs(g - prev).max()


@pytest.mark.parametrize("dims,cols", [((2, 4), 16), ((4, 2), 8), ((8, 1), 8)])
def test_jacobi2d_matches_reference_and_oracle(dims, cols):
    """tests/test_topology.py:201, on three process grids."""
    tr, tc = 8 // dims[0], cols // dims[1]
    kw = dict(tile_rows=tr, tile_cols=tc, iters=25, dims=dims)
    tile, resid = trun(jacobi2d_program, **kw)
    jtile, jresid = run_spmd(lambda comm: jax_jacobi2d(comm, **kw))
    np.testing.assert_allclose(tile, np.asarray(jtile).reshape(tile.shape),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(resid, np.ravel(np.asarray(jresid)), rtol=1e-6)
    want, want_res = oracle_jacobi(8, cols, 25)
    got = np.zeros((8, cols), np.float32)
    for r in range(P):
        row, col = divmod(r, dims[1])
        got[row * tr:(row + 1) * tr, col * tc:(col + 1) * tc] = tile[r]
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(resid[0], want_res, rtol=1e-3)


def test_jacobi2d_1xN_matches_jacobi1d():
    """tests/test_topology.py:221: dims (P, 1) is the 1-D row
    decomposition of examples/jacobi.py, to the bit."""
    t2, r2 = trun(jacobi2d_program, tile_rows=4, tile_cols=12, iters=20,
                  dims=(P, 1))
    t1, r1 = trun(jacobi_program, rows_per_rank=4, cols=12, iters=20)
    np.testing.assert_array_equal(t2, t1)
    np.testing.assert_array_equal(r2, r1)


def test_graph_neighbor_allgather():
    """tests/test_topology.py:425."""
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7),
             (7, 0), (0, 4), (2, 6), (5, 1)]
    data = np.arange(8.0, dtype=np.float32) * 10
    g = graph_create(TorchCommunicator(8), edges)
    got = trun(lambda comm, x: g.neighbor_allgather(x[comm.rank], fill=-1.0), data)
    mesh = default_mesh(8)
    jg = jgraph_create(TpuCommunicator("world", mesh), edges)
    want = np.asarray(run_spmd(lambda comm, x: jg.neighbor_allgather(
        x[comm.rank], fill=-1.0), data, mesh=mesh))
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    for r in range(8):
        in_nb = g.in_neighbors_of(r)
        np.testing.assert_array_equal(got[r, :len(in_nb)], [data[s] for s in in_nb])
        np.testing.assert_array_equal(got[r, len(in_nb):], -1.0)


def test_graph_neighbor_alltoall():
    """tests/test_topology.py:452."""
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (3, 1)]
    g = graph_create(TorchCommunicator(4), edges)
    maxo = g.max_out_degree
    blocks = (100 * np.arange(4)[:, None] + np.arange(maxo)[None, :]).astype(np.float32)
    got = trun(lambda comm, x: g.neighbor_alltoall(x[comm.rank][:, None], fill=-1.0),
               blocks, nranks=4)
    mesh = default_mesh(4)
    jg = jgraph_create(TpuCommunicator("world", mesh), edges)
    want = np.asarray(run_spmd(lambda comm, x: jg.neighbor_alltoall(
        x[comm.rank][:, None], fill=-1.0), blocks, mesh=mesh, nranks=4))
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    got = got.reshape(4, g.max_in_degree)
    for r in range(4):
        in_nb = g.in_neighbors_of(r)
        expect = [100 * s + g.out_neighbors_of(s).index(r) for s in in_nb]
        np.testing.assert_array_equal(got[r, :len(in_nb)], expect)
        np.testing.assert_array_equal(got[r, len(in_nb):], -1.0)


def test_graph_over_split_communicator_runs_per_group():
    """The lookup tables have one entry per world rank: a ring graph over
    two groups of four runs in both groups."""
    world = TorchCommunicator(8)
    halves = world.split_by(lambda i: i // 4)
    g = graph_create(halves, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)])
    got = mpi_tpu_torch.run(
        lambda comm: g.neighbor_allgather(comm.rank.to(torch.float32), fill=-1.0),
        comm=world, device="cpu").numpy()
    for w in range(8):
        base, r = w - w % 4, w % 4
        in_nb = g.in_neighbors_of(r)
        np.testing.assert_array_equal(got[w, :len(in_nb)], [base + s for s in in_nb])
        np.testing.assert_array_equal(got[w, len(in_nb):], -1.0)


def test_graph_rejects_self_edges_and_edgeless_is_empty():
    with pytest.raises(ValueError, match="self-edge"):
        graph_create(TorchCommunicator(4), [(1, 1)])
    g = graph_create(TorchCommunicator(4), [])
    out = trun(lambda comm: g.neighbor_allgather(comm.rank.to(torch.float32)), nranks=4)
    assert out.shape == (4, 0)


def test_graph_in_order_sets_each_ranks_neighbor_order():
    """GraphComm's in_order/out_order (mpi_tpu/topology.py:274-302): rank 2
    names its sources reversed, and its receipts follow that order, in
    both packages."""
    from mpi_tpu.topology import GraphComm as JGraphComm
    from mpi_tpu_torch.topology import GraphComm

    edges = [(0, 2), (1, 2), (2, 3), (3, 0)]
    in_order = [[3], [], [1, 0], [2]]
    out_order = [[2], [2], [3], [0]]
    data = np.arange(4.0, dtype=np.float32) * 10
    g = GraphComm(TorchCommunicator(4), edges, in_order=in_order, out_order=out_order)
    got = trun(lambda comm, x: g.neighbor_allgather(x[comm.rank], fill=-1.0), data,
               nranks=4)
    mesh = default_mesh(4)
    jg = JGraphComm(TpuCommunicator("world", mesh), edges, in_order=in_order,
                    out_order=out_order)
    want = np.asarray(run_spmd(lambda comm, x: jg.neighbor_allgather(
        x[comm.rank], fill=-1.0), data, mesh=mesh, nranks=4))
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    np.testing.assert_array_equal(got[2], [10.0, 0.0])
    assert g.in_neighbors_of(2) == jg.in_neighbors_of(2) == [1, 0]


@pytest.mark.parametrize("what", ["in_order", "out_order"])
def test_graph_order_naming_other_neighbors_raises(what):
    from mpi_tpu.topology import GraphComm as JGraphComm
    from mpi_tpu_torch.topology import GraphComm

    edges = [(0, 1), (1, 2), (2, 0)]
    bad = {what: [[2], [0], [9]]}
    with pytest.raises(ValueError) as mine:
        GraphComm(TorchCommunicator(3), edges, **bad)
    with pytest.raises(ValueError) as ref:
        JGraphComm(TpuCommunicator("world", default_mesh(3)), edges, **bad)
    assert str(mine.value) == str(ref.value)
    assert what in str(mine.value)


def test_dist_graph_create_adjacent_raises_under_spmd():
    """The reference's SPMD diagnosis (mpi_tpu/topology.py:733-738): per-rank
    adjacency lists cannot be collected in one SPMD program."""
    from mpi_tpu.topology import dist_graph_create_adjacent as jadjacent

    def tprog(comm):
        mpi_tpu_torch.dist_graph_create_adjacent(comm, [0], [1])

    with pytest.raises(TypeError, match="graph_create") as mine:
        mpi_tpu_torch.run(tprog, nranks=4, device="cpu")
    with pytest.raises(TypeError, match="graph_create") as ref:
        run_spmd(lambda comm, _: jadjacent(comm, [0], [1]),
                 np.zeros(1, np.float32), mesh=default_mesh(4), nranks=4)
    assert str(mine.value) == str(ref.value)
