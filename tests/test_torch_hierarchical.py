"""The port's hierarchical splits (``topology.multihost_node_key``,
``split_hierarchical``, ``split_hierarchical3``, ``HierarchicalComm``)
against the reference's.

Held unchanged on the port (``tests/test_torch_host_ref.py``: the
reference's inputs, oracles and assertions): ``tests/test_coll_sm.py:517``
(2 nodes of 2 on shm rank threads: each node's intra communicator served
by its arena, the wire between the leaders), and ``tests/test_tuning.py``
``:370`` (three levels, 2 nodes x 2 NUMA x 2, every collective),
``:412`` (each level's ``"auto"`` keys the tuned resolver with its own
communicator: one ``tuned_table_hits`` per DCN member), ``:431`` and
``:441`` (one node without a multi-process runtime).  The cases below run
one seeded float32 program through both packages' rank threads and
compare rank by rank, bitwise (the tiers fold in the same order), and
check that tensors keep their device and dtype through every tier.
"""

import numpy as np
import pytest
import torch

import mpi_tpu
import mpi_tpu_torch
from mpi_tpu import topology as ref_topology
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import topology
from tests.test_torch_host_local import assert_same
from tests.test_torch_host_ref import port_cases

globals().update(port_cases("test_coll_sm", only=(
    "test_hierarchical_dispatch_arena_intra_wire_inter",)))
globals().update(port_cases("test_tuning", only=(
    "test_three_level_parity_with_injected_keys",
    "test_three_level_routes_dcn_level_through_resolver",
    "test_two_level_hierarchy_unchanged",
    "test_multihost_node_key_single_process")))

FORMS = {
    "two-level": dict(node_key=lambda r: r // 2),
    "two-level-ragged": dict(node_key=lambda r: min(r // 3, 1)),
    "three-level": dict(node_key=lambda r: r // 4, numa_key=lambda r: (r // 2) % 2),
}


def _prog(form, root):
    def prog(c, m, arr):
        topo = topology if m is mpi_tpu_torch else ref_topology
        h = topo.HierarchicalComm(c, **FORMS[form])
        x = arr(np.random.default_rng(c.rank).standard_normal(37)
                .astype(np.float32))
        out = [h.allreduce(x), h.allreduce(x, m.MAX),
               h.bcast(x if c.rank == root else None, root=root),
               h.reduce(x, root=root), h.allgather(x), h.n_nodes]
        h.barrier()
        return out
    return prog


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("root", [0, 5])
def test_hierarchical_collectives_match_reference(form, root):
    n = 8
    prog = _prog(form, root)
    ref = ref_run_local(lambda c: prog(c, mpi_tpu, np.asarray), n)
    got = mpi_tpu_torch.run(
        lambda c: prog(c, mpi_tpu_torch, lambda a: torch.from_numpy(np.asarray(a))),
        backend="local", nranks=n, device="cpu")
    for r in range(n):
        assert_same(ref[r], got[r], f"rank {r}")
    assert got[0][0].dtype == torch.float32 and got[0][4].shape == (n, 37)


def test_split_hierarchical_shapes_match_reference():
    def prog(c, m):
        topo = topology if m is mpi_tpu_torch else ref_topology
        intra, leaders, node_of = topo.split_hierarchical(c, lambda r: r % 3)
        numa, nl, dcn, numa_of, node_of3 = topo.split_hierarchical3(
            c, numa_key=lambda r: r % 2, node_key=lambda r: r // 3)
        size = lambda x: None if x is None else (x.rank, x.size)  # noqa: E731
        return (size(intra), size(leaders), node_of, size(numa), size(nl),
                size(dcn), numa_of, node_of3)

    ref = ref_run_local(lambda c: prog(c, mpi_tpu), 6)
    got = mpi_tpu_torch.run(lambda c: prog(c, mpi_tpu_torch), backend="local",
                            nranks=6, device="cpu")
    assert ref == got


def test_multihost_node_key_reads_torch_distributed_when_initialized():
    """Without an initialized ``torch.distributed`` every rank is node 0
    (the reference's fallback); the key is a pure function of the rank."""
    assert not torch.distributed.is_initialized()
    keys = mpi_tpu_torch.run(
        lambda c: [topology.multihost_node_key(c)(r) for r in range(c.size)],
        backend="local", nranks=3, device="cpu")
    assert keys == [[0, 0, 0]] * 3
