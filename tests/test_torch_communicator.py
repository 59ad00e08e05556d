"""The scenarios of tests/test_tpu_backend.py run through both packages:
the JAX ``run_spmd`` with a ``TpuCommunicator`` and the port's ``run`` with
a ``TorchCommunicator``, on the same numpy inputs.

Tolerances: hand-scheduled algorithms are bitwise (same schedule, same fold
order).  The fused tier is XLA's psum on one side and a torch reduction
over the rank dimension on the other, whose summation orders differ: those
results agree to rtol 1e-6 (float32, 8 terms).  Exact-valued scenarios
(integers, copies, max/min) are compared exactly.
"""

import warnings

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import mpi_tpu_torch
from mpi_tpu import ops as jops
from mpi_tpu.tpu import SpmdSemanticsError as JaxSpmdError
from mpi_tpu.tpu import TpuCommunicator, default_mesh, run_spmd
from mpi_tpu_torch import (SpmdContextError, SpmdSemanticsError,
                           TorchCommunicator)
from mpi_tpu_torch import ops as tops
from mpi_tpu_torch.gpu.window import TorchWindow
from mpi_tpu_torch.interop import to_numpy

P = 8


def data(n=P, shape=(5,), seed=0, dtype=np.float32):
    return np.asarray(np.random.RandomState(seed).randn(n, *shape), dtype)


def trun(prog, *args, **kw):
    out = mpi_tpu_torch.run(prog, *args, nranks=kw.pop("nranks", P),
                            device="cpu", **kw)
    if isinstance(out, tuple):
        return tuple(to_numpy(o) for o in out)
    return to_numpy(out)


def jrun(prog, *args, **kw):
    return np.asarray(run_spmd(prog, *args, **kw))


def close(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- allreduce -----------------------------------------------------------------


@pytest.mark.parametrize("algo", ["fused", "ring", "recursive_halving", "reduce_bcast"])
def test_allreduce_sum(algo):
    d = data(shape=(13,))
    want = jrun(lambda c, x: c.allreduce(x[c.rank], op=jops.SUM, algorithm=algo), d)
    got = trun(lambda c, x: c.allreduce(x[c.rank], op=tops.SUM, algorithm=algo), d)
    close(got, want, exact=algo != "fused")
    for r in range(P):
        np.testing.assert_allclose(got[r], d.sum(0), rtol=1e-5)


@pytest.mark.parametrize("algo", ["fused", "ring", "recursive_halving"])
@pytest.mark.parametrize("opname", ["MAX", "MIN", "PROD"])
def test_allreduce_ops(algo, opname):
    d = data(shape=(6,), seed=3)
    jop, top = getattr(jops, opname), getattr(tops, opname)
    want = jrun(lambda c, x: c.allreduce(x[c.rank], op=jop, algorithm=algo), d)
    got = trun(lambda c, x: c.allreduce(x[c.rank], op=top, algorithm=algo), d)
    close(got, want, exact=algo != "fused" or opname != "PROD")


def test_allreduce_int_dtype():
    d = np.arange(P * 4, dtype=np.int32).reshape(P, 4)
    want = jrun(lambda c, x: c.allreduce(x[c.rank], algorithm="ring"), d)
    got = trun(lambda c, x: c.allreduce(x[c.rank], algorithm="ring"), d)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


# -- bcast / reduce --------------------------------------------------------------


@pytest.mark.parametrize("algo", ["fused", "tree"])
@pytest.mark.parametrize("root", [0, 3, 7])
def test_bcast(algo, root):
    d = data(shape=(4,), seed=5)
    want = jrun(lambda c, x: c.bcast(x[c.rank], root=root, algorithm=algo), d)
    got = trun(lambda c, x: c.bcast(x[c.rank], root=root, algorithm=algo), d)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algo", ["fused", "tree"])
@pytest.mark.parametrize("root", [0, 5])
def test_reduce_sum_at_root(algo, root):
    d = data(shape=(4,), seed=6)
    want = jrun(lambda c, x: c.reduce(x[c.rank], op=jops.SUM, root=root, algorithm=algo), d)
    got = trun(lambda c, x: c.reduce(x[c.rank], op=tops.SUM, root=root, algorithm=algo), d)
    close(got, want, exact=algo == "tree")
    assert np.all(np.delete(got, root, axis=0) == 0.0)


@pytest.mark.parametrize("algo", ["fused", "tree"])
def test_reduce_max_identity_on_non_roots(algo):
    d = -np.abs(data(shape=(3,), seed=7))
    want = jrun(lambda c, x: c.reduce(x[c.rank], op=jops.MAX, root=2, algorithm=algo), d)
    got = trun(lambda c, x: c.reduce(x[c.rank], op=tops.MAX, root=2, algorithm=algo), d)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[[r for r in range(P) if r != 2]] == np.float32(-np.inf))


# -- allgather / gather / alltoall -----------------------------------------------


@pytest.mark.parametrize("algo", ["fused", "ring", "doubling"])
def test_allgather(algo):
    d = data(shape=(3,), seed=8)
    want = jrun(lambda c, x: c.allgather(x[c.rank], algorithm=algo), d)
    got = trun(lambda c, x: c.allgather(x[c.rank], algorithm=algo), d)
    np.testing.assert_array_equal(got, want)


def test_gather_sharded_zero_comm():
    """gather(sharded=True): each rank returns its own [1, ...] slice, so
    the stacked result is the gathered stack with no collective at all."""
    d = data(shape=(6,), seed=31)
    from mpi_tpu_torch.gpu import primitives

    calls = []
    orig = primitives.all_gather
    primitives.all_gather = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        got = trun(lambda c, x: c.gather(x[c.rank], sharded=True), d)
    finally:
        primitives.all_gather = orig
    np.testing.assert_array_equal(got.reshape(P, 6), d)
    assert calls == []


def test_gather_replicated_warns_above_threshold():
    d = data(shape=(64,), seed=32)
    old = TorchCommunicator.gather_replicated_warn_bytes
    TorchCommunicator.gather_replicated_warn_bytes = 128
    try:
        with pytest.warns(RuntimeWarning, match="sharded=True"):
            got = trun(lambda c, x: c.gather(x[c.rank]), d)
    finally:
        TorchCommunicator.gather_replicated_warn_bytes = old
    for r in range(P):
        np.testing.assert_array_equal(got[r], d)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        trun(lambda c, x: c.gather(x[c.rank]), d)


def test_gatherv_sharded_padded_blocks_and_ragged_concat():
    counts = [3, 1, 2, 4, 2, 3, 1, 2]
    maxc = max(counts)
    d = np.asarray(np.random.RandomState(33).randn(P, maxc, 2), np.float32)
    stack = trun(lambda c, x: c.gatherv(x[c.rank], counts, sharded=True), d)
    got = to_numpy(TorchCommunicator.ragged_concat(torch.from_numpy(stack), counts))
    want = TpuCommunicator.ragged_concat(stack, counts)
    np.testing.assert_array_equal(got, want)
    for r in range(P):
        np.testing.assert_array_equal(stack[r, counts[r]:], 0.0)
    rep_j = jrun(lambda c, x: c.gatherv(x[c.rank], counts), d)[0]
    rep_t = trun(lambda c, x: c.gatherv(x[c.rank], counts), d)[0]
    np.testing.assert_array_equal(rep_t, rep_j)


@pytest.mark.parametrize("algo", ["fused", "pairwise"])
def test_alltoall(algo):
    d = np.asarray([[src * 100 + dst for dst in range(P)] for src in range(P)],
                   np.float32)[..., None]
    want = jrun(lambda c, x: c.alltoall(x[c.rank], algorithm=algo)[:, 0], d)
    got = trun(lambda c, x: c.alltoall(x[c.rank], algorithm=algo)[:, 0], d)
    np.testing.assert_array_equal(got, want)


# -- p2p -------------------------------------------------------------------------


def _rank_f(c, lib):
    return c.rank.astype(jnp.float32) if lib == "jax" else c.rank.to(torch.float32)


@pytest.mark.parametrize("offset,wrap,fill", [(1, True, None), (1, False, -99.0),
                                              (-1, True, None), (3, False, 7.0)])
def test_shift(offset, wrap, fill):
    want = jrun(lambda c: c.shift(_rank_f(c, "jax"), offset=offset, wrap=wrap, fill=fill))
    got = trun(lambda c: c.shift(_rank_f(c, "torch"), offset=offset, wrap=wrap, fill=fill))
    np.testing.assert_array_equal(got.ravel(), want.ravel())


def test_exchange_static_pattern():
    want = jrun(lambda c: c.exchange(_rank_f(c, "jax") + 1, [(0, 7), (3, 4)]))
    got = trun(lambda c: c.exchange(_rank_f(c, "torch") + 1, [(0, 7), (3, 4)]))
    np.testing.assert_array_equal(got.ravel(), want.ravel())
    got = trun(lambda c: c.exchange(_rank_f(c, "torch") + 1, [(0, 7)], fill=-1.0))
    np.testing.assert_array_equal(got.ravel(), [-1] * 7 + [1.0])


def test_shift_no_wrap_requires_fill():
    world = TorchCommunicator(P)
    with pytest.raises(SpmdSemanticsError, match="fill"):
        world.shift(torch.zeros(3), offset=1, wrap=False)
    with pytest.raises(JaxSpmdError, match="fill"):
        TpuCommunicator("world", default_mesh()).shift(jnp.zeros(3), offset=1, wrap=False)


def test_send_raises_spmd_diagnostic():
    comm = TorchCommunicator(P)
    with pytest.raises(SpmdSemanticsError, match="shift"):
        comm.send(1, dest=0)
    for call in (comm.recv, lambda: comm.sendrecv(1, dest=0),
                 lambda: comm.isend(1, 0), comm.irecv, comm.probe, comm.iprobe,
                 lambda: comm.split(color=0)):
        with pytest.raises(SpmdSemanticsError):
            call()
    assert issubclass(SpmdSemanticsError, NotImplementedError)


# -- split -----------------------------------------------------------------------


def test_split_parity_groups():
    sub = TorchCommunicator(P).split_by(lambda i: i % 2)
    jsub = TpuCommunicator("world", default_mesh()).split_by(lambda i: i % 2)
    assert sub.size == 4
    assert sub.axis_index_groups == jsub.axis_index_groups == [[0, 2, 4, 6], [1, 3, 5, 7]]
    want = jrun(lambda c: jsub.allreduce(_rank_f(c, "jax"), algorithm="ring"))
    got = trun(lambda c: sub.allreduce(_rank_f(c, "torch"), algorithm="ring"))
    np.testing.assert_array_equal(got.ravel(), want.ravel())
    np.testing.assert_array_equal(got.ravel(), [12.0, 16.0] * 4)


@pytest.mark.parametrize("algo", ["fused", "ring", "recursive_halving"])
def test_split_grouped_collectives(algo):
    jrows = TpuCommunicator("world", default_mesh()).split_by(lambda i: i // 4)
    rows = TorchCommunicator.from_groups(jrows.axis_index_groups)
    d = data(shape=(9,), seed=11)
    want = jrun(lambda c, x: jrows.allreduce(x[c.rank], op=jops.SUM, algorithm=algo), d)
    got = trun(lambda c, x: rows.allreduce(x[c.rank], op=tops.SUM, algorithm=algo), d)
    close(got, want, exact=algo != "fused")


def test_split_key_reorders_and_nested_split():
    world, jworld = TorchCommunicator(P), TpuCommunicator("world", default_mesh())
    keys = list(range(P - 1, -1, -1))
    assert world.split_all([0] * P, keys=keys).axis_index_groups == \
        jworld.split_all([0] * P, keys=keys).axis_index_groups == [list(range(7, -1, -1))]
    sub = world.split_by(lambda i: i // 4).split_by(lambda i: i % 2)
    jsub = jworld.split_by(lambda i: i // 4).split_by(lambda i: i % 2)
    assert sub.axis_index_groups == jsub.axis_index_groups == [[0, 2], [1, 3], [4, 6], [5, 7]]
    got = trun(lambda c: sub.allgather(_rank_f(c, "torch")))
    want = jrun(lambda c: jsub.allgather(_rank_f(c, "jax")))
    np.testing.assert_array_equal(got, want)


def test_split_rejections():
    world = TorchCommunicator(P)
    with pytest.raises(ValueError, match="equal-sized"):
        world.split_all([0, 0, 0, 1, 1, 1, 1, 1])
    with pytest.raises(ValueError, match="color"):
        world.split_all([None, 0, 0, 0, 0, 0, 0, 1])
    with pytest.raises(ValueError, match="equal-sized"):
        TorchCommunicator.from_groups([[0, 1, 2], [3]])


def test_split_type_create_dup():
    world = TorchCommunicator(P)
    assert world.split_type().axis_index_groups == [list(range(P))]

    class Group:
        ranks = [5, 1]

    created = world.create(Group())
    jcreated = TpuCommunicator("world", default_mesh()).create(Group())
    assert created.axis_index_groups == jcreated.axis_index_groups
    assert world.dup().axis_index_groups is None
    kinds = []
    trun(lambda c: (kinds.append(type(c.win_create(torch.zeros(2)))), c.rank)[1])
    assert kinds == [TorchWindow]


# -- misc ------------------------------------------------------------------------


def test_barrier_and_rank():
    def prog(c):
        c.barrier()
        assert c.ibarrier().wait() is None
        return c.rank

    np.testing.assert_array_equal(trun(prog).ravel(), np.arange(P))


def test_scatter():
    d = np.arange(P * P, dtype=np.float32).reshape(P, P)
    want = jrun(lambda c, x: c.scatter(jnp.where(c.rank == 3, x, jnp.zeros_like(x)), root=3), d)
    got = trun(lambda c, x: c.scatter(torch.where(c.rank == 3, x, torch.zeros_like(x)), root=3), d)
    np.testing.assert_array_equal(got, want)


def test_run_requires_nranks():
    with pytest.raises(ValueError, match="nranks"):
        mpi_tpu_torch.run(lambda c: c.rank, device="cpu")


def test_grouped_shift_stays_in_group():
    rows = TorchCommunicator(P).split_by(lambda i: i // 4)
    got = trun(lambda c: rows.shift(_rank_f(c, "torch"), offset=1, wrap=True))
    np.testing.assert_array_equal(got.ravel(), [3, 0, 1, 2, 7, 4, 5, 6])


@pytest.mark.parametrize("opname", ["SUM", "MAX"])
def test_scan_exscan(opname):
    d = data(shape=(3,), seed=12)
    jop, top = getattr(jops, opname), getattr(tops, opname)
    for method in ("scan", "exscan"):
        want = jrun(lambda c, x: getattr(c, method)(x[c.rank], op=jop), d)
        got = trun(lambda c, x: getattr(c, method)(x[c.rank], op=top), d)
        np.testing.assert_array_equal(got, want)


def test_maxloc_minloc():
    d = np.round(data(shape=(4,), seed=13) * 2) / 2  # ties across ranks
    for method in ("maxloc", "minloc"):
        jv, jl = run_spmd(lambda c, x: getattr(c, method)(x[c.rank]), d)
        tv, tl = trun(lambda c, x: getattr(c, method)(x[c.rank]), d)
        np.testing.assert_array_equal(tv, np.asarray(jv))
        np.testing.assert_array_equal(tl, np.asarray(jl))


def test_vector_collectives():
    counts = [1, 2, 0, 3, 1, 1, 2, 2]
    d = data(shape=(3, 2), seed=14)
    for prog_j, prog_t in (
            (lambda c, x: c.allgatherv(x[c.rank], counts),
             lambda c, x: c.allgatherv(x[c.rank], counts)),
            (lambda c, x: c.scatterv(jnp.tile(x[0], (4, 1)), counts, root=2),
             lambda c, x: c.scatterv(x[0].repeat(4, 1), counts, root=2))):
        np.testing.assert_array_equal(trun(prog_t, d), jrun(prog_j, d))
    cm = [[(i + j) % 3 for j in range(P)] for i in range(P)]
    blocks = data(n=P, shape=(P, 2, 3), seed=15)
    want = jrun(lambda c, x: c.alltoallv(x[c.rank], cm), blocks)
    got = trun(lambda c, x: c.alltoallv(x[c.rank], cm), blocks)
    np.testing.assert_array_equal(got, want)


def test_nonblocking_requests():
    d = data(shape=(4,), seed=16)
    got = trun(lambda c, x: c.iallreduce(x[c.rank], algorithm="ring").wait(), d)
    want = jrun(lambda c, x: c.iallreduce(x[c.rank], algorithm="ring").wait(), d)
    np.testing.assert_array_equal(got, want)


def test_collectives_only_inside_run():
    world = TorchCommunicator(P)
    with pytest.raises(SpmdContextError, match="run_spmd"):
        world.allreduce(torch.ones(3))
    with pytest.raises(SpmdContextError):
        world.rank
    with pytest.raises(ValueError, match="spans 4 ranks"):
        mpi_tpu_torch.run(lambda c: TorchCommunicator(4).rank, nranks=P, device="cpu")
