"""The port's host-backend RMA (``mpi_tpu_torch/window.py`` ``P2PWindow``
/ ``DynamicWindow``, ``shmwin.py`` ``SharedWindow``) against the
reference's: the programs of ``tests/test_window.py`` and
``tests/test_window_property.py`` (their process-backend cases) run in
both packages on the same inputs — local rank threads, and shm worlds
for a few — and must give bitwise equal windows, fetched values
and diagnoses: fence epochs, passive target, PSCW, the MPI-3 atomics,
flush and request-based RMA, dynamic windows and shared windows."""

import time

import numpy as np
import pytest
import torch

import mpi_tpu
import mpi_tpu_torch
from mpi_tpu import ops as ref_ops
from mpi_tpu.transport.base import RecvTimeout as RefRecvTimeout
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import ops
from mpi_tpu_torch.transport.base import RecvTimeout
from mpi_tpu_torch.transport.local import run_local
from mpi_tpu_torch.transport.shm import run_shm
from tests.test_shm_backend import run_shm_world as ref_run_shm
from tests.test_torch_host_local import assert_same, to_torch

P = 4


class Pkg:
    def __init__(self, port: bool):
        self.port = port
        self.ops = ops if port else ref_ops
        self.RecvTimeout = RecvTimeout if port else RefRecvTimeout
        self.win_allocate_shared = (mpi_tpu_torch.win_allocate_shared if port
                                    else mpi_tpu.win_allocate_shared)

    def a(self, x, dtype=None):
        x = np.asarray(x, dtype)
        return to_torch(x) if self.port else x

    def copy(self, x):
        return x.clone() if self.port else np.copy(x)


REF, PORT = Pkg(False), Pkg(True)


def both(prog, n, world="local"):
    runners = {"local": (ref_run_local,
                         lambda f, k: run_local(f, k, device="cpu",
                                                timeout=60)),
               "shm": (ref_run_shm,
                       lambda f, k: run_shm(f, k, device="cpu", timeout=60,
                                            ring_bytes=256 * 1024))}[world]
    ref = runners[0](lambda c: prog(c, REF), n)
    got = runners[1](lambda c: prog(c, PORT), n)
    assert_same(ref, got)
    return got


# -- fence epochs --------------------------------------------------------------


def ring_put(c, k):
    win = c.win_create(k.a(np.zeros(3, np.float32)))
    win.put(k.a(np.ones(3, np.float32) * (c.rank + 1)),
            [(r, (r + 1) % c.size) for r in range(c.size)])
    win.fence()
    return win.local


def accumulate_twice(c, k):
    win = c.win_create(k.a(np.ones(2, np.float32)))
    mine = k.a(np.ones(2, np.float32) * c.rank)
    pairs = [(r, (r + 1) % c.size) for r in range(c.size)]
    win.accumulate(mine, pairs, op=k.ops.SUM)
    win.accumulate(mine, pairs, op=k.ops.SUM)
    win.fence()
    return win.local


def get_after_put(c, k):
    win = c.win_create(k.a(np.zeros((), np.float32)))
    win.put(k.a(np.float32(10.0) * c.rank),
            [(r, (r + 1) % c.size) for r in range(c.size)])
    fut = win.get([((r + 1) % c.size, r) for r in range(c.size)], fill=-1.0)
    win.fence()
    return fut.value


def loc_put(c, k):
    win = c.win_create(k.a(np.zeros(4, np.float32)))
    win.put(k.a(np.ones(2, np.float32) * (c.rank + 1)),
            [(r, (r + 1) % c.size) for r in range(c.size)], loc=slice(1, 3))
    win.fence()
    return win.local


def int_target_accumulate(c, k):
    win = c.win_create(k.a(np.zeros(1, np.float64)))
    if c.rank != 0:
        win.accumulate(k.a(np.array([float(c.rank)])), 0)
    win.fence()
    return win.local[0]


def int_target_get(c, k):
    win = c.win_create(k.a(np.array([c.rank * 2.0])))
    fut = win.get((c.rank + 1) % c.size)
    win.fence()
    return fut.value[0]


def max_accumulate(c, k):
    win = c.win_create(k.a(np.full(3, 5.0)))
    win.accumulate(k.a(np.array([1.0, 7.0, float(c.rank)])),
                   [(r, 0) for r in range(c.size) if r != 0][:1],
                   op=k.ops.MAX)
    win.fence()
    return win.local


@pytest.mark.parametrize("prog", [ring_put, accumulate_twice, get_after_put,
                                  loc_put, int_target_accumulate,
                                  int_target_get, max_accumulate])
def test_fence_epochs_bitwise(prog):
    both(prog, P)


@pytest.mark.parametrize("prog", [ring_put, int_target_accumulate])
def test_fence_epochs_on_shm(prog):
    both(prog, P, world="shm")


def test_two_windows_interleaved_epochs():
    def prog(c, k):
        win1 = c.win_create(k.a(np.zeros(2)))
        win2 = c.win_create(k.a(np.zeros(2)))
        ring = [(r, (r + 1) % c.size) for r in range(c.size)]
        win1.put(k.a(np.full(2, c.rank + 1.0)), ring)
        win1.fence()
        if c.rank == 1:
            time.sleep(0.05)
        win2.put(k.a(np.full(2, c.rank + 10.0)), ring)
        win2.fence()
        return win1.local[0], win2.local[0]

    both(prog, P)


def test_get_future_before_fence_and_freed_window_rejected():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(1)))
        fut = win.get([(0, 1)])
        try:
            fut.value
        except RuntimeError as e:
            early = str(e)
        win.fence()
        win.free()
        try:
            win.put(k.a(np.ones(1)), [(0, 1)])
        except RuntimeError as e:
            return early, str(e)

    both(prog, 2)


# -- passive target ------------------------------------------------------------


def test_passive_put_get_without_target_participation():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(4, np.float32)))
        c.barrier()
        if c.rank == 0:
            win.lock(1)
            win.put_at(1, k.a(np.arange(4.0, dtype=np.float32)))
            win.accumulate_at(1, k.a(np.ones(4, np.float32)))
            got = win.get_at(1)
            win.unlock(1)
            c.barrier()
            return got
        c.barrier()
        return k.copy(win.local)

    both(prog, 3)


def test_exclusive_lock_serializes_read_modify_write():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros((), np.int64)))
        c.barrier()
        for _ in range(10):
            win.lock(0)
            win.put_at(0, win.get_at(0) + 1)
            win.unlock(0)
        c.barrier()
        return int(win.local)

    both(prog, 4)


def test_shared_locks_and_self_lock():
    def prog(c, k):
        win = c.win_create(k.a(np.full(2, c.rank, np.float32)))
        c.barrier()
        t = (c.rank + 1) % c.size
        win.lock(t, exclusive=False)
        got = win.get_at(t)
        win.unlock(t)
        c.barrier()
        win.lock(c.rank)
        win.put_at(c.rank, k.a(np.full(2, 7.0, np.float32)))
        mine = win.get_at(c.rank)
        win.unlock(c.rank)
        c.barrier()
        win.free()
        return got, mine

    both(prog, 4)


def test_passive_and_fence_epochs_coexist():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(2, np.float32)))
        win.accumulate(k.a(np.ones(2, np.float32)),
                       [(r, (r + 1) % c.size) for r in range(c.size)])
        win.fence()
        c.barrier()
        if c.rank == 0:
            win.lock(1)
            win.accumulate_at(1, k.a(np.full(2, 10.0, np.float32)))
            win.unlock(1)
        c.barrier()
        return k.copy(win.local)

    both(prog, 3)


def test_op_failures_surface_at_the_origin_and_the_server_survives():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(4, np.float32)))
        c.barrier()
        out = []
        if c.rank == 0:
            win.lock(1)
            win.put_at(1, k.a(np.ones(3, np.float32)), loc=slice(0, 2))
            try:
                win.unlock(1)
            except RuntimeError as e:
                out.append("failed at target" in str(e))
            win.lock(1, exclusive=False)
            try:
                win.get_at(1, loc=slice(0, 99, 0))  # zero step: bad loc
            except RuntimeError as e:
                out.append("get failed" in str(e))
            win.unlock(1)
            win.lock(1)
            win.put_at(1, k.a(np.full(4, 5.0, np.float32)))
            win.unlock(1)
        win.lock(c.rank)
        win.put_at(c.rank, k.a(np.ones(3, np.float32)), loc=slice(0, 2))
        try:
            win.unlock(c.rank)
        except RuntimeError as e:
            out.append("failed at target" in str(e))
        c.barrier()
        return out, k.copy(win.local)

    got = both(prog, 2)
    assert got[0][0] == [True, True, True] and got[1][0] == [True]


def test_passive_reply_waits_honor_recv_timeout():
    def prog(c, k):
        c.recv_timeout = 0.5
        win = c.win_create(k.a(np.zeros(2, np.float32)))
        if c.rank == 0:
            win.lock(1)
            c.send(b"locked", dest=1, tag=98)
            c.recv(source=1, tag=99)
            try:
                win.get_at(1)
                return False
            except k.RecvTimeout:
                return True
        c.recv(source=0, tag=98)
        win._srv_comm._send_internal(("stop",), c.rank, -8)
        win._srv_thread.join(timeout=5)
        c.send(b"dead", dest=0, tag=99)
        time.sleep(1.2)
        return True

    assert both(prog, 2) == [True, True]


# -- PSCW ------------------------------------------------------------------


def test_pscw_put_visible_after_wait_and_test():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(2)))
        if c.rank == 0:
            win.post([1, 2])
            while not win.test():
                time.sleep(0.001)
            win.wait()
            out = k.copy(win.local)
        else:
            win.start([0])
            win.accumulate_at(0, k.a(np.array([float(c.rank), 0.5])))
            win.complete()
            out = None
        c.barrier()
        win.free()
        return out

    both(prog, 3)


def test_pscw_epoch_discipline_and_errors():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(2)))
        msgs = []
        try:
            win.complete()
        except RuntimeError as e:
            msgs.append(str(e))
        if c.rank == 0:
            win.post([1])
            win.wait()
        else:
            win.start([0])
            try:
                win.start([0])
            except RuntimeError as e:
                msgs.append(str(e))
            win.put_at(0, k.a(np.zeros(3)))  # wrong shape
            try:
                win.complete()
            except RuntimeError as e:
                msgs.append(str(e).split(":")[0])
        c.barrier()
        win.free()
        return msgs

    both(prog, 2)


def test_pscw_wait_times_out_on_a_silent_origin():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(1)))
        out = None
        if c.rank == 0:
            c.recv_timeout = 0.5
            win.post([1])
            try:
                win.wait()
            except k.RecvTimeout as e:
                out = "never completed" in str(e)
        c.barrier()
        win.free()
        return out

    assert both(prog, 2)[0] is True


# -- atomics, flush, request-based RMA -------------------------------------


def test_fetch_and_op_counter_and_compare_and_swap():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(1, np.int64)))
        c.barrier()
        old = sorted(int(win.fetch_and_op(0, k.a(np.ones(1, np.int64)))[0])
                     for _ in range(5))
        c.barrier()
        cas = None
        if c.rank == 1:
            a = win.compare_and_swap(0, k.a(np.full(1, 20, np.int64)),
                                     k.a(np.full(1, 7, np.int64)))
            b = win.compare_and_swap(0, k.a(np.zeros(1, np.int64)),
                                     k.a(np.full(1, 9, np.int64)))
            cas = (int(a[0]), int(b[0]))
        c.barrier()
        total = int(win.local[0]) if c.rank == 0 else None
        c.barrier()
        win.free()
        return len(old), cas, total

    got = both(prog, 4)
    assert got[0][2] == 7 and got[1][1] == (20, 7)


def test_flush_surfaces_errors_inside_the_epoch():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(2)))
        c.barrier()
        out = None
        if c.rank == 1:
            win.lock(0)
            win.put_at(0, k.a(np.zeros(5)))
            try:
                win.flush(0)
            except RuntimeError as e:
                out = "failed at target" in str(e)
            win.put_at(0, k.a(np.ones(2)))
            win.flush(0)
            win.unlock(0)
        c.barrier()
        final = k.copy(win.local) if c.rank == 0 else None
        c.barrier()
        win.free()
        return out, final

    both(prog, 2)


def test_lock_all_flush_all_and_request_rma():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(1)))
        c.barrier()
        got = None
        if c.rank == 1:
            win.lock_all()
            reqs = [win.raccumulate(t, k.a(np.ones(1)))
                    for t in range(c.size)]
            win.flush_all()
            for r in reqs:
                r.wait()
                assert r.test() == (True, None)
            got = win.rget(0).wait()
            before = win._flush_epoch(0)
            win.rput(0, k.a(np.full(1, 7.0))).wait()
            assert win._flush_epoch(0) == before + 1
            win.unlock_all()
        c.barrier()
        local = k.copy(win.local)
        c.barrier()
        win.free()
        return got, local

    both(prog, 3)


def test_get_accumulate_array_payload():
    def prog(c, k):
        win = c.win_create(k.a(np.arange(3.0)))
        c.barrier()
        old = None
        if c.rank == 1:
            old = win.get_accumulate(0, k.a(np.full(3, 10.0)))
        c.barrier()
        final = k.copy(win.local) if c.rank == 0 else None
        c.barrier()
        win.free()
        return old, final

    both(prog, 2)


def test_atomics_respect_an_exclusive_lock():
    def prog(c, k):
        win = c.win_create(k.a(np.zeros(1, np.int64)))
        c.barrier()
        prev = None
        if c.rank == 1:
            win.lock(0, exclusive=True)
            c.barrier()
            time.sleep(0.2)  # rank 2's atomic arrives mid-epoch
            old = int(win.get_at(0)[0])
            win.put_at(0, k.a(np.asarray([old + 100], np.int64)))
            win.unlock(0)
        elif c.rank == 2:
            c.barrier()
            prev = int(win.fetch_and_op(0, k.a(np.ones(1, np.int64)))[0])
        else:
            c.barrier()
        c.barrier()
        final = int(win.local[0]) if c.rank == 0 else None
        c.barrier()
        win.free()
        return prev, final

    got = both(prog, 3)
    assert got[2][0] == 100 and got[0][1] == 101


# -- dynamic windows ---------------------------------------------------------


def test_dynamic_window_attach_rma_detach():
    def prog(c, k):
        win = c.win_create_dynamic()
        c.barrier()
        if c.rank == 0:
            win.attach("grid", k.a(np.zeros(4)))
            win.attach("halo", k.a(np.zeros(2)))
        c.barrier()
        out = None
        if c.rank == 1:
            win.lock(0)
            win.put_at(0, k.a(np.arange(4.0)), loc="grid")
            win.accumulate_at(0, k.a(np.ones(2)), loc="halo")
            win.put_at(0, k.a(np.asarray([-1.0])), loc=("grid", slice(0, 1)))
            out = win.get_at(0, loc="halo")
            win.unlock(0)
        c.barrier()
        final = ((win.detach("grid"), win.detach("halo"))
                 if c.rank == 0 else None)
        c.barrier()
        win.free()
        return out, final

    both(prog, 2)


def test_dynamic_window_unattached_region_diagnosed():
    def prog(c, k):
        win = c.win_create_dynamic()
        c.barrier()
        msgs = []
        if c.rank == 1:
            win.lock(0)
            win.put_at(0, k.a(np.ones(2)), loc="nope")
            win.put_at(0, k.a(np.ones(1)), loc=(["un", "hashable"], 0))
            try:
                win.unlock(0)
            except RuntimeError as e:
                msgs.append(str(e))
            try:
                win.fetch_and_op(1, k.a(np.ones(1)))
            except RuntimeError as e:
                msgs.append(str(e))
            try:
                win.attach("x", k.a(np.ones(1)))
                win.attach("x", k.a(np.ones(1)))
            except ValueError as e:
                msgs.append(str(e))
        c.barrier()
        win.free()
        return msgs

    got = both(prog, 2)
    assert len(got[1]) == 3 and "not attached" in got[1][0]


# -- shared windows ---------------------------------------------------------


@pytest.mark.parametrize("world", ["local", "shm"])
def test_shared_window_load_store_across_ranks(world):
    def prog(c, k):
        win = k.win_allocate_shared(c, 4, np.float64)
        win.local[:] = k.a(c.rank * 10 + np.arange(4.0))
        win.fence()
        left = (c.rank - 1) % c.size
        got = k.copy(win.remote(left))
        win.fence()
        if c.rank == 0:
            for r in range(c.size):
                win.remote(r)[0] = -1.0
        win.fence()
        poked = float(win.local[0])
        win.free()
        return got, poked

    both(prog, 3, world=world)


def test_shared_window_ragged_sizes_whole_and_freed():
    def prog(c, k):
        win = k.win_allocate_shared(c, c.rank + 1, np.float32)
        win.local[:] = float(c.rank)
        win.fence()
        whole = k.copy(win.whole) if c.rank == 0 else None
        sizes = [len(win.remote(r)) for r in range(c.size)]
        win.sync()
        win.fence()
        win.free()
        try:
            win.local
        except RuntimeError as e:
            return whole, sizes, str(e)

    got = both(prog, 3)
    assert got[0][0].dtype == torch.float32  # host memory, the asked dtype


def test_shared_window_refused_outside_the_host_backends():
    from mpi_tpu_torch import TorchCommunicator

    msgs = []
    for fn, comm in ((mpi_tpu.win_allocate_shared, object()),
                     (mpi_tpu_torch.win_allocate_shared, object())):
        with pytest.raises(NotImplementedError) as ei:
            fn(comm, 4)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert TorchCommunicator is not None


# -- the property test: random epochs against an oracle ------------------------

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

PP = 3


def _perm():
    return st.permutations(range(PP)).flatmap(
        lambda dsts: st.lists(st.booleans(), min_size=PP, max_size=PP).map(
            lambda keep: [(s, d) for s, d in enumerate(dsts) if keep[s]]))


def _data(src, ei, oi):
    return float(src * 100 + ei * 10 + oi + 1)


def _oracle(program):
    wins = [np.zeros(2) for _ in range(PP)]
    for ei, epoch in enumerate(program):
        for oi, (kind, pairs) in enumerate(epoch):
            for s, d in pairs:
                v = _data(s, ei, oi)
                if kind == "put":
                    wins[d][...] = v
                else:
                    wins[d][...] += v
    return np.stack(wins)


@given(program=st.lists(st.lists(st.tuples(st.sampled_from(["put", "acc"]),
                                           _perm()), max_size=4),
                        min_size=1, max_size=3))
@settings(max_examples=20, deadline=None)
def test_rma_random_epochs_match_the_oracle(program):
    def prog(c):
        win = c.win_create(torch.zeros(2, dtype=torch.float64))
        for ei, epoch in enumerate(program):
            for oi, (kind, pairs) in enumerate(epoch):
                data = torch.full((2,), _data(c.rank, ei, oi),
                                  dtype=torch.float64)
                if kind == "put":
                    win.put(data, pairs)
                else:
                    win.accumulate(data, pairs, op=ops.SUM)
            win.fence()
        return win.local

    got = torch.stack(run_local(prog, PP, device="cpu", timeout=60)).numpy()
    np.testing.assert_array_equal(got, _oracle(program))
