"""The port's progress engine against the reference's (``tests/
test_progress.py`` without its verifier tests, ROADMAP 16.2b, and its
shm tests, 16.4): background completion of a posted irecv, the
collective family's results and wire frames under ``progress="thread"``
against ``progress="none"``, the segmented engine's send window advanced
by the engine, the fault-tolerance bound with the engine running, the
off-mode contract (no engine, the ``progress_*`` pvars at 0) and the
mode resolution — the same programs on the same seeded inputs through
``mpi_tpu.transport.local.run_local`` and the port's ``run_local`` with
``device="cpu"``, results bitwise equal."""

import os
import time

import numpy as np
import pytest
import torch

from mpi_tpu import progress as ref_progress
from mpi_tpu_torch import communicator, progress
from mpi_tpu_torch.errors import RevokedError
from mpi_tpu_torch.transport.base import RecvTimeout
from tests.test_torch_host_local import assert_same, seeded
from tests.test_torch_host_nbc import (DETECT_S, PORT, REF, both, cvars,  # noqa: F401
                                       deltas, recorder)

PROGRESS_PVARS = ("progress_wakeups", "progress_completions",
                  "progress_idle_parks")


def engines_gone(timeout=10.0):
    """Wait for the engine threads of finished worlds (either package) to
    leave their last pass: the progress pvars are process-wide."""
    import threading

    deadline = time.monotonic() + timeout
    for t in threading.enumerate():
        if t.name.startswith(("mpi-tpu-progress", "mpi-tpu-torch-progress")):
            t.join(max(0.0, deadline - time.monotonic()))


def test_irecv_completes_in_background_local():
    """``req._done`` flips while the receiver only sleeps: completion is
    engine-owned, not caller-financed."""
    def prog(c, m):
        if c.rank == 0:
            time.sleep(0.1)
            c.send(m.arr(np.arange(8.0)), 1, tag=5)
            return None
        req = c.irecv(0, 5)
        deadline = time.time() + 10
        while not req._done and time.time() < deadline:
            time.sleep(0.01)  # deliberately no wait()/test()
        done = req._done
        return done, req.wait()

    ref, got = both(prog, 2, progress="thread")
    assert got[1][0] is True


def test_user_buffer_refilled_by_the_engine():
    """An irecv(buf=) completed by the engine thread refills the caller's
    tensor in place."""
    def prog(c):
        if c.rank == 0:
            c.send(torch.arange(6.0), 1, tag=2)
            return None
        buf = torch.zeros(6)
        req = c.irecv(0, 2, buf=buf)
        deadline = time.time() + 10
        while not req._done and time.time() < deadline:
            time.sleep(0.01)
        req.wait()
        return buf

    got = PORT.run(lambda c, m: prog(c), 2, progress="thread")
    assert torch.equal(got[1], torch.arange(6.0))


def _family(c, m):
    x = m.arr(seeded(c.size, (1 << 12,), np.float32, seed=7)[c.rank])
    r1 = c.allreduce(x, algorithm="ring")
    r2 = c.ialltoall([m.arr(np.full(8, c.rank * 10.0 + d)) for d in range(c.size)]).wait()
    r3 = c.iallreduce(m.arr(np.float64(c.rank))).wait()
    c.barrier()
    return r1, r2, r3


def test_collective_parity_and_wire_contract_under_thread():
    """The family is bitwise equal under the engine and without it, in
    both packages; engine completion consumes delivered payloads and adds
    no wire traffic (the frames are the blocking run's) and no pickling."""
    runs = {}
    for pkg in (REF, PORT):
        for mode in ("thread", "none"):
            log = {}
            engines_gone()
            res, d = deltas(pkg, ("bytes_pickled_sent", "progress_wakeups"),
                            lambda: pkg.run(_family, 3, progress=mode,
                                            transport_wrapper=recorder(pkg, log)))
            assert d["bytes_pickled_sent"] == 0
            assert (d["progress_wakeups"] > 0) == (mode == "thread")
            frames = {r: [(dst, tag, nb) for dst, _, tag, nb in f]
                      for r, f in log.items()}
            runs[(pkg.port, mode)] = (res, frames)
    ref_res, ref_frames = runs[(False, "none")]
    for key, (res, frames) in runs.items():
        assert frames == ref_frames, key
        for r in range(3):
            assert_same(ref_res[r], res[r], f"{key} rank {r}")


def test_seg_window_advanced_by_engine(cvars):
    """Forced multi-segment exchanges under the engine: the credit
    window's tail sends are posted by completion callbacks
    (``_SegSender.advance``), and the folds stay bitwise."""
    cvars("collective_segment_bytes", 64)

    def prog(c, m):
        x = m.arr(np.arange(2048, dtype=np.float64) + c.rank)
        return (c.allreduce(x, algorithm="ring"),
                c.allreduce(x, algorithm="recursive_halving"),
                c.allreduce(x, algorithm="rabenseifner"))

    ref, got = both(prog, 2, progress="thread")
    want = torch.arange(2048, dtype=torch.float64) * 2 + 1
    assert all(torch.equal(t, want) for t in got[0])


def test_revoke_unblocks_a_segmented_exchange_under_the_engine(cvars):
    """A rank inside a many-segment ring exchange whose send window the
    engine advances is unblocked by a peer's revoke: the RevokedError
    reaches the caller (from its sliced wait or from a send), never
    stays on the engine thread."""
    cvars("collective_segment_bytes", 64)
    cvars("fault_detect_timeout_s", 30.0)

    def prog(c, m):
        x = torch.arange(4096, dtype=torch.float64)
        if c.rank == 0:
            c.revoke()
            return "revoked"
        try:
            for _ in range(50):
                c.allreduce(x, algorithm="ring")
        except RevokedError as e:
            return type(e).__name__
        return "completed"

    got = PORT.run(prog, 2, progress="thread", fault_tolerance=True)
    assert got == ["revoked", "RevokedError"]


def test_engine_wait_honors_recv_timeout():
    """The engine-parked wait keeps the communicator's recv_timeout."""
    def prog(c, m):
        c.recv_timeout = 0.3
        try:
            c.irecv(1 - c.rank, tag=4).wait()
        except RecvTimeout as e:
            return "timed out" in str(e)
        return False

    assert PORT.run(prog, 2, progress="thread") == [True, True]


def test_ft_kill_mid_ialltoall_detection_bound_unchanged(cvars):
    cvars("fault_detect_timeout_s", DETECT_S)
    cvars("fault_heartbeat_interval_s", 0.05)

    def prog(c, m):
        blocks = [m.arr(np.ones(1 << 12) * d) for d in range(c.size)]
        if c.rank == 1:
            c.alltoall(blocks)  # dies on send 2
            return "unreachable"
        t0 = time.monotonic()
        try:
            c.ialltoall(blocks).wait()
        except m.ProcFailedError as e:
            assert time.monotonic() - t0 < 6 * DETECT_S
            return type(e).__name__, e.failed
        return None

    out = {}
    for pkg in (REF, PORT):
        wrap = (lambda pk: lambda inner: (pk.Faulty(inner, kill_after_n=2)
                                          if inner.world_rank == 1 else inner))(pkg)
        out[pkg.port] = pkg.run(prog, 3, transport_wrapper=wrap,
                                fault_tolerance=True, progress="thread")
        assert out[pkg.port][1] is pkg.KILLED
    for r in (0, 2):
        assert out[True][r] == out[False][r] == ("ProcFailedError", (1,))


def test_off_mode_zero_wakeups_and_single_attribute():
    def prog(c, m):
        assert c._progress is None
        assert getattr(c._t, "_progress_engine", None) is None
        c.allreduce(m.arr(np.arange(64.0)))
        r = c.ialltoall([m.arr(np.arange(4.0))] * c.size).wait()
        # mpilint: ok (posted and never matched: still no engine)
        c.irecv(c.rank, 1)
        c.barrier()  # mpilint: ok (this world never revokes)
        return r

    for pkg in (REF, PORT):
        engines_gone()
        _, d = deltas(pkg, PROGRESS_PVARS, lambda: pkg.run(prog, 2, progress="none"))
        assert d == {k: 0 for k in PROGRESS_PVARS}, (pkg.port, d)


def test_mode_resolution_and_cvar(cvars):
    """Explicit argument > MPI_TPU_PROGRESS > the ``progress`` cvar, in both
    packages alike; bad values refused everywhere."""
    old_env = os.environ.pop("MPI_TPU_PROGRESS", None)
    try:
        for mod in (ref_progress, progress):
            assert mod.resolve_mode("thread") == "thread"
            assert mod.resolve_mode() == "none"
        cvars("progress", "thread")
        for mod in (ref_progress, progress):
            assert mod.resolve_mode() == "thread"
        os.environ["MPI_TPU_PROGRESS"] = "none"
        for mod in (ref_progress, progress):
            assert mod.resolve_mode() == "none"
            assert mod.resolve_mode("thread") == "thread"
    finally:
        if old_env is None:
            os.environ.pop("MPI_TPU_PROGRESS", None)
        else:
            os.environ["MPI_TPU_PROGRESS"] = old_env
    msgs = []
    for mod in (ref_progress, progress):
        with pytest.raises(ValueError) as ei:
            mod.resolve_mode("fibers")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    from mpi_tpu import mpit as ref_mpit
    from mpi_tpu_torch import mpit

    for m in (ref_mpit, mpit):
        with pytest.raises(ValueError):
            m.cvar_write("progress", "fibers")
        with pytest.raises(ValueError):
            m.cvar_write("nbc_fold_workers", 0)
        with pytest.raises(ValueError):
            m.cvar_write("nbc_sm_max_bytes", -1)
        with pytest.raises(ValueError):
            m.cvar_write("fault_detect_timeout_s", 0)
        with pytest.raises(ValueError):
            m.cvar_write("epoch_grace_s", -1)
        with pytest.raises(ValueError):
            m.cvar_write("link_keepalive_s", -1)


def test_engine_stop_on_close_transport():
    """``close_transport`` (finalize) stops the engine and its fold pool."""
    from mpi_tpu_torch.transport.local import LocalTransport, LocalWorld

    comm = communicator.P2PCommunicator(
        LocalTransport(LocalWorld(1, device=torch.device("cpu")), 0), range(1))
    progress.enable(comm)
    eng = comm._progress
    assert comm.iallreduce(torch.ones(3)).wait().tolist() == [1.0, 1.0, 1.0]
    comm.close_transport()
    eng.thread.join(5.0)
    assert not eng.thread.is_alive()
