"""RMA windows (``TorchCommunicator.win_create`` → ``gpu/window.py``) against
the JAX package's ``TpuWindow`` on the CPU.

The programs are those of tests/test_window.py:24-95 and the random epochs
of tests/test_window_property.py:72, written once for each package (numpy
times a batched rank does not mix with torch); both run on the same inputs
and must agree bitwise (``assert_array_equal``): a window only copies and
adds small integers in float32.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import mpi_tpu_torch
from mpi_tpu import ops as jops
from mpi_tpu.tpu import run_spmd
from mpi_tpu_torch import SpmdSemanticsError
from mpi_tpu_torch import ops as tops

P = 4


def trun(prog, nranks=P):
    return mpi_tpu_torch.run(prog, nranks=nranks, device="cpu").numpy()


def jrun(prog, nranks=P):
    return np.asarray(run_spmd(prog, nranks=nranks))


def ring(p=P):
    return [(r, (r + 1) % p) for r in range(p)]


# -- the programs of tests/test_window.py, once per package ---------------------


def ring_put(lib, comm):
    win = comm.win_create(lib.zeros(3))
    win.put(lib.ones(3) * (comm.rank + 1), ring())
    win.fence()
    return win.local


def accumulate(lib, comm):
    win = comm.win_create(lib.ones(2))
    mine = lib.ones(2) * comm.rank
    op = (jops if lib is jnp else tops).SUM
    win.accumulate(mine, ring(), op=op)
    win.accumulate(mine, ring(), op=op)
    win.fence()
    return win.local


def get_after_put(lib, comm):
    win = comm.win_create(lib.zeros(()))
    win.put(lib.zeros(()) + 10.0 * comm.rank, ring())
    fut = win.get([((r + 1) % P, r) for r in range(P)], fill=-1.0)
    win.fence()
    return fut.value


def multi_epoch(lib, comm):
    win = comm.win_create(lib.zeros(2))
    one = comm.localize(lib.ones(2))
    all_self = [(r, r) for r in range(P)]
    win.accumulate(one, all_self)
    win.fence()
    win.accumulate(one, all_self)
    win.fence()
    return win.local


def at_loc(lib, comm):
    win = comm.win_create(lib.zeros(4))
    win.put(lib.ones(2) * (comm.rank + 1), ring(), loc=np.s_[1:3])
    win.fence()
    return win.local


def acc_at_loc_and_get_at_loc(lib, comm):
    win = comm.win_create(lib.zeros((2, 3)))
    win.accumulate(lib.ones(3) * (comm.rank + 1), ring(), loc=1)
    win.accumulate(lib.ones(3) * 5.0, [(0, 2)], loc=1)
    fut = win.get(ring(), fill=7.0, loc=(1, np.s_[0:2]))
    win.fence()
    return win.local, fut.value


@pytest.mark.parametrize("prog", [ring_put, accumulate, get_after_put,
                                  multi_epoch, at_loc])
def test_programs_match_reference(prog):
    """tests/test_window.py:96: the reference's expected windows, bitwise."""
    got = trun(lambda c: prog(torch, c))
    want = jrun(lambda c: prog(jnp, c))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


def test_expected_windows():
    """The values of tests/test_window.py:80-95."""
    r = np.arange(P)
    left = (r - 1) % P
    np.testing.assert_array_equal(trun(lambda c: ring_put(torch, c)),
                                  np.repeat(left[:, None] + 1.0, 3, 1))
    np.testing.assert_array_equal(trun(lambda c: accumulate(torch, c)),
                                  np.repeat(1.0 + 2.0 * left[:, None], 2, 1))
    np.testing.assert_array_equal(trun(lambda c: get_after_put(torch, c)), 10.0 * r)
    np.testing.assert_array_equal(trun(lambda c: multi_epoch(torch, c)),
                                  np.full((P, 2), 2.0))


def test_loc_accumulate_and_loc_get_match_reference():
    got = mpi_tpu_torch.run(lambda c: acc_at_loc_and_get_at_loc(torch, c),
                            nranks=P, device="cpu")
    want = run_spmd(lambda c: acc_at_loc_and_get_at_loc(jnp, c), nranks=P)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_split_communicator_windows_run_per_group():
    """A window over a split communicator: the ring pattern runs inside
    each group of four of an 8-rank world."""
    world = mpi_tpu_torch.TorchCommunicator(8)
    halves = world.split_by(lambda i: i // 4)

    def prog(comm):
        return ring_put(torch, halves)

    got = mpi_tpu_torch.run(prog, comm=world, device="cpu").numpy()
    gr = np.arange(8) % 4
    np.testing.assert_array_equal(got[:, 0], (gr - 1) % 4 + 1.0)


def test_rejects_dynamic_int_target():
    """tests/test_window.py:159: an int target is an SpmdSemanticsError."""
    def prog(comm):
        win = comm.win_create(torch.zeros(1))
        with pytest.raises(SpmdSemanticsError, match="rank-dynamic RMA"):
            win.put(torch.ones(1), 0)
        with pytest.raises(SpmdSemanticsError, match="rank-dynamic RMA"):
            win.get(comm.rank)
        return comm.rank

    trun(prog)


def test_future_before_fence_and_freed_window():
    def prog(comm):
        win = comm.win_create(torch.zeros(1))
        fut = win.get(ring())
        with pytest.raises(RuntimeError, match="closing fence"):
            _ = fut.value
        win.fence()
        win.free()
        with pytest.raises(RuntimeError, match="freed"):
            win.fence()
        return fut.value

    trun(prog)


@pytest.mark.parametrize("call", [
    # tests/test_window.py:320 (passive target)
    lambda w: w.lock(0), lambda w: w.unlock(0), lambda w: w.put_at(0, 1.0),
    lambda w: w.get_at(0), lambda w: w.accumulate_at(0, 1.0),
    # :678 (atomics, flush, PSCW)
    lambda w: w.fetch_and_op(0, 1.0), lambda w: w.compare_and_swap(0, 1.0, 2.0),
    lambda w: w.flush(0), lambda w: w.post([0]), lambda w: w.start([0]),
    lambda w: w.complete(), lambda w: w.wait(), lambda w: w.test(),
    # :760 (MPI-3 helpers)
    lambda w: w.lock_all(), lambda w: w.unlock_all(), lambda w: w.flush_all(),
    lambda w: w.flush_local(0), lambda w: w.flush_local_all(),
    lambda w: w.get_accumulate(0, 1.0), lambda w: w.rput(0, 1.0),
    lambda w: w.rget(0), lambda w: w.raccumulate(0, 1.0),
])
def test_passive_target_and_mpi3_diagnoses(call):
    """The reference's diagnosis: passive target has no SPMD spelling."""
    def prog(comm):
        win = comm.win_create(torch.zeros(2))
        with pytest.raises(NotImplementedError, match="fence epochs") as exc:
            call(win)
        assert "SPMD" in str(exc.value)
        win.sync()  # valid on any window
        return comm.rank

    trun(prog)


# -- random epochs (tests/test_window_property.py:72) ---------------------------

NP = 3


def perm_strategy():
    return st.permutations(range(NP)).flatmap(
        lambda dsts: st.lists(st.booleans(), min_size=NP, max_size=NP).map(
            lambda keep: [(s, d) for s, d in enumerate(dsts) if keep[s]]))


program_strategy = st.lists(
    st.lists(st.tuples(st.sampled_from(["put", "acc"]), perm_strategy()),
             min_size=0, max_size=4), min_size=1, max_size=3)


def epochs(lib, program, comm):
    ops_mod = jops if lib is jnp else tops
    win = comm.win_create(lib.zeros(2))
    for ei, epoch in enumerate(program):
        for oi, (kind, pairs) in enumerate(epoch):
            data = lib.zeros(2) + (comm.rank * 100.0 + ei * 10.0 + oi + 1.0)
            if kind == "put":
                win.put(data, pairs)
            else:
                win.accumulate(data, pairs, op=ops_mod.SUM)
        win.fence()
    return win.local


@given(program=program_strategy)
@settings(max_examples=10, deadline=None)
def test_random_epochs_match_reference(program):
    got = trun(lambda c: epochs(torch, program, c), nranks=NP)
    want = jrun(lambda c: epochs(jnp, program, c), nranks=NP)
    np.testing.assert_array_equal(got, want)
