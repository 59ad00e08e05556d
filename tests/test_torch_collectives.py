"""Every hand-scheduled algorithm of mpi_tpu_torch/gpu/collectives.py
against mpi_tpu/tpu/collectives.py, each through its package's runner, on
the same numpy inputs, for the whole world and for split groups.

Tolerance: bitwise.  Both packages run the same schedule with the same
fold order (``op.combine(own, received)`` at the same step), so every
result is the same float.
"""

import numpy as np
import pytest

import torch

import mpi_tpu_torch
from mpi_tpu import ops as jops
from mpi_tpu.tpu import TpuCommunicator, default_mesh, run_spmd
from mpi_tpu_torch import TorchCommunicator
from mpi_tpu_torch import ops as tops
from mpi_tpu_torch.gpu import collectives as talgos
from mpi_tpu_torch.interop import to_numpy

P = 8
SPLIT = [[0, 2, 4, 6], [1, 3, 5, 7]]


def spread(shape, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * 10.0 ** rs.uniform(-4, 8, size=shape)).astype(np.float32)


def comms(split: bool):
    """The same communicator in both packages."""
    jworld = TpuCommunicator("world", default_mesh(P))
    if not split:
        return jworld, TorchCommunicator(P)
    jsub = jworld.split_by(lambda i: i % 2)
    assert jsub.axis_index_groups == SPLIT
    return jsub, TorchCommunicator.from_groups(SPLIT)


def both(method, split, data, *args, **kwargs):
    """Call ``comm.<method>(x[rank], *args, **kwargs)`` in both packages;
    ``args``/``kwargs`` may hold op names, resolved per package."""
    jc, tc = comms(split)

    def resolve(v, mod):
        return getattr(mod, v) if isinstance(v, str) and v.isupper() else v

    jargs = [resolve(a, jops) for a in args]
    targs = [resolve(a, tops) for a in args]
    jkw = {k: resolve(v, jops) for k, v in kwargs.items()}
    tkw = {k: resolve(v, tops) for k, v in kwargs.items()}

    def jprog(comm, x):
        return getattr(jc, method)(x[comm.rank], *jargs, **jkw)

    def tprog(comm, x):
        return getattr(tc, method)(x[comm.rank], *targs, **tkw)

    want = np.asarray(run_spmd(jprog, data))
    got = to_numpy(mpi_tpu_torch.run(tprog, data, nranks=P, device="cpu"))
    return got, want


def assert_bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "PROD"])
@pytest.mark.parametrize("algo", ["ring", "recursive_halving"])
def test_allreduce(algo, op, split):
    data = (np.random.RandomState(1).randn(P, 37).astype(np.float32)
            if op == "PROD" else spread((P, 37), 1))
    assert_bitwise(*both("allreduce", split, data, op=op, algorithm=algo))


@pytest.mark.parametrize("split", [False, True])
def test_allreduce_reduce_bcast(split):
    assert_bitwise(*both("allreduce", split, spread((P, 21), 2), op="SUM",
                         algorithm="reduce_bcast"))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("root", [0, 3])
def test_tree_bcast(root, split):
    assert_bitwise(*both("bcast", split, spread((P, 5), 3), root=root,
                         algorithm="tree"))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("op", ["SUM", "MAX"])
def test_tree_reduce(op, split):
    assert_bitwise(*both("reduce", split, spread((P, 6), 4), op=op, root=1,
                         algorithm="tree"))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("algo", ["ring", "doubling"])
def test_allgather(algo, split):
    assert_bitwise(*both("allgather", split, spread((P, 3, 2), 5),
                         algorithm=algo))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("op", ["SUM", "MIN"])
def test_ring_reduce_scatter(op, split):
    size = 4 if split else P
    assert_bitwise(*both("reduce_scatter", split, spread((P, size, 7), 6),
                         op=op, algorithm="ring"))


@pytest.mark.parametrize("split", [False, True])
def test_pairwise_alltoall(split):
    size = 4 if split else P
    assert_bitwise(*both("alltoall", split, spread((P, size, 3), 7),
                         algorithm="pairwise"))


def test_int_payload_ring():
    data = np.arange(P * 4, dtype=np.int32).reshape(P, 4)
    assert_bitwise(*both("allreduce", False, data, algorithm="ring"))


def test_tree_reduce_local_matches_reference():
    from mpi_tpu.tpu import collectives as jalgos

    stacked = spread((5, 9), 8)
    want = np.asarray(jalgos.tree_reduce_local(jops.SUM, stacked))
    got = talgos.tree_reduce_local(tops.SUM, torch.from_numpy(stacked)).numpy()
    assert_bitwise(got, want)


def test_halving_rejects_non_pow2():
    world = TorchCommunicator(6)
    with pytest.raises(ValueError, match="power-of-two"):
        mpi_tpu_torch.run(lambda c: world.allreduce(
            torch.ones(3), algorithm="recursive_halving"), comm=world,
            device="cpu")
