"""The port's intercommunicators (``mpi_tpu_torch/intercomm.py``) against
the reference's.

The twelve cases of ``tests/test_intercomm.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``: the reference's inputs, oracles and
assertions, on ``run_local(..., device="cpu")``), except ``:143``, whose
SPMD communicator is the reference's ``TpuCommunicator``: the port's
diagnostic for its ``TorchCommunicator`` is
``test_spmd_backend_diagnostic_torch`` below.  The seeded cases below run
one program through both packages and compare rank by rank, bitwise (the
inter-allreduce folds the remote group's payloads in remote rank order in
both)."""

import numpy as np
import pytest
import torch

import mpi_tpu
import mpi_tpu_torch
from mpi_tpu.transport.local import run_local as ref_run_local
from tests.test_torch_host_local import assert_same
from tests.test_torch_host_ref import port_cases

globals().update(port_cases("test_intercomm", {
    "test_spmd_backend_diagnostic": (
        "constructs the reference's TpuCommunicator; the port's diagnostic "
        "for TorchCommunicator is test_spmd_backend_diagnostic_torch"),
}))


def both(prog, n):
    ref = ref_run_local(lambda c: prog(c, mpi_tpu, np.asarray), n)
    got = mpi_tpu_torch.run(
        lambda c: prog(c, mpi_tpu_torch, lambda a: torch.from_numpy(np.asarray(a))),
        backend="local", nranks=n, device="cpu")
    for r in range(n):
        assert_same(ref[r], got[r], f"rank {r}")
    return got


@pytest.mark.parametrize("split", [(2, 3), (1, 4), (3, 2)])
def test_cross_group_collectives_match_reference(split):
    a, b = list(range(split[0])), list(range(split[0], sum(split)))

    def prog(c, m, arr):
        x = arr(np.random.default_rng(c.rank).standard_normal(5).astype(np.float32))
        ic = m.create_intercomm(c, a, b)
        out = [ic.allreduce(x), ic.allreduce(x, m.MAX), ic.allgather(x),
               ic.alltoall([x * (j + 1) for j in range(ic.remote_size)])]
        root_side = c.rank in a
        out.append(ic.bcast(x if ic.rank == 0 and root_side else None,
                            root=(mpi_tpu.intercomm.ROOT if ic.rank == 0 else
                                  mpi_tpu.intercomm.PROC_NULL) if root_side else 0))
        merged = ic.merge(high=not root_side)
        out.append((merged.rank, merged.size, merged.allreduce(x)))
        return out

    got = both(prog, sum(split))
    assert got[0][0].dtype == torch.float32


def test_spmd_backend_diagnostic_torch():
    def prog(comm):
        with pytest.raises(NotImplementedError, match="split_by"):
            mpi_tpu_torch.create_intercomm(comm, [0, 1], [2, 3])
        return comm.allreduce(comm.rank.float())

    mpi_tpu_torch.run(prog, nranks=4, device="cpu")
