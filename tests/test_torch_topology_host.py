"""The port's process topologies on the host backends against the
reference's (ROADMAP Queue 3 item 1).

The reference's host cases of ``tests/test_topology.py`` (:84, :99, :110,
:237, :258, :300, :311, :323, :351, :367, :384, :407) run unchanged on
the port's ``run_local(..., device="cpu")`` (``tests/test_torch_host_ref.py``),
each with the reference's oracle and tolerance; ``:188`` runs the port's
own ``jacobi2d`` example against the same oracle (atol 1e-6, the
reference's).  The graph cases below run the same seeded program through
both packages' ``run_local`` and compare rank by rank bitwise (the
neighbor collectives only move payloads), and pin that the SPMD results
and the SPMD ``TypeError`` of ``dist_graph_create_adjacent`` did not
change.
"""

import numpy as np
import pytest
import torch

import mpi_tpu
import mpi_tpu_torch
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import topology
from mpi_tpu_torch.examples.jacobi2d import jacobi2d_program
from tests.test_topology import oracle_jacobi
from tests.test_torch_host_local import assert_same
from tests.test_torch_host_ref import port_cases

globals().update(port_cases("test_topology", only=(
    "test_cart_shift_local", "test_cart_exchange_local", "test_cart_sub_local",
    "test_cart_shift_dim_out_of_range_rejected",
    "test_neighbor_alltoall_wrong_count", "test_neighbors_of_order",
    "test_graph_neighbor_allgather_local", "test_graph_neighbor_alltoall_local",
    "test_dist_graph_create_adjacent_matches_global",
    "test_dist_graph_adjacent_respects_each_ranks_order")))

EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]


def both(prog, n):
    ref = ref_run_local(lambda c: prog(c, mpi_tpu, np.asarray), n)
    got = mpi_tpu_torch.run(
        lambda c: prog(c, mpi_tpu_torch, lambda a: torch.from_numpy(np.asarray(a))),
        backend="local", nranks=n, device="cpu")
    for r in range(n):
        assert_same(ref[r], got[r], f"rank {r}")
    return ref, got


def test_graph_neighbor_allgather_host_matches_reference():
    """The acceptance input: 4 ranks, edges (0,1) (1,2) (2,3) (3,0) (0,2);
    a list per in-neighbor, in in-neighbor order."""
    ref, got = both(lambda c, m, arr: m.graph_create(c, EDGES)
                    .neighbor_allgather(arr([float(c.rank)])), 4)
    assert [[float(x[0]) for x in r] for r in got] == [[3.0], [0.0],
                                                         [1.0, 0.0], [2.0]]


def test_graph_neighbor_alltoall_host_matches_reference():
    def prog(c, m, arr):
        g = m.graph_create(c, EDGES)
        rng = np.random.default_rng(c.rank)
        return g.neighbor_alltoall(
            [arr(rng.standard_normal(3).astype(np.float32))
             for _ in g.out_neighbors_of(c.rank)])

    both(prog, 4)


@pytest.mark.parametrize("n", [3, 5])
def test_dist_graph_create_adjacent_host_matches_reference(n):
    def prog(c, m, arr):
        r = c.rank
        g = m.dist_graph_create_adjacent(c, [(r - 1) % n], [(r + 1) % n])
        return ([g.in_neighbors_of(q) for q in range(n)],
                g.neighbor_allgather(arr([r * 10.0])))

    ref, got = both(prog, n)
    assert got[0][0] == [[(q - 1) % n] for q in range(n)]


def test_graph_neighbor_collectives_keep_the_payloads_device():
    def prog(c):
        g = topology.graph_create(c, EDGES)
        x = torch.full((2,), float(c.rank), dtype=torch.float64)
        a = g.neighbor_allgather(x)
        b = g.neighbor_alltoall([x + d for d in g.out_neighbors_of(c.rank)])
        return [t.device.type for t in a + b], [t.dtype for t in a + b]

    for devs, dtypes in mpi_tpu_torch.run(prog, backend="local", nranks=4,
                                          device="cpu"):
        assert set(devs) == {"cpu"} and set(dtypes) == {torch.float64}


def test_spmd_graph_results_and_type_error_unchanged():
    """The SPMD path still stacks [max_in_degree, ...] padded with fill,
    and dist_graph_create_adjacent still raises its TypeError there."""
    def prog(c):
        g = topology.graph_create(c, EDGES)
        with pytest.raises(TypeError, match="graph_create instead"):
            topology.dist_graph_create_adjacent(c, [0], [1])
        return g.neighbor_allgather(c.rank.float() * 10, fill=-1.0)

    out = mpi_tpu_torch.run(prog, nranks=4, device="cpu")
    assert out.tolist() == [[30.0, -1.0], [0.0, -1.0], [10.0, 0.0],
                            [20.0, -1.0]]


@pytest.mark.parametrize("dims", [(2, 2), (4, 1), (1, 4)])
def test_jacobi2d_matches_oracle_local(dims):
    """``tests/test_topology.py:188`` with the port's jacobi2d example on
    4 rank threads: the tiles within atol 1e-6 of the numpy oracle and the
    residual within rtol 1e-4, the reference's tolerances."""
    tr, tc = 8 // dims[0], 8 // dims[1]
    res = mpi_tpu_torch.run(
        lambda comm: jacobi2d_program(comm, tile_rows=tr, tile_cols=tc,
                                      iters=30, dims=dims),
        backend="local", nranks=4, device="cpu")
    want, want_res = oracle_jacobi(8, 8, 30)
    tiles = np.zeros((8, 8), np.float32)
    for r, (tile, resid) in enumerate(res):
        row, col = divmod(r, dims[1])
        tiles[row * tr:(row + 1) * tr, col * tc:(col + 1) * tc] = tile.numpy()
        np.testing.assert_allclose(float(resid), want_res, rtol=1e-4)
    np.testing.assert_allclose(tiles, want, atol=1e-6)
