"""The port's fault tolerance (ULFM) against the reference's: the programs
of ``tests/test_fault_tolerance.py`` (without its shm cases, ROADMAP
16.4; its ``checkpoint.save`` cases ``:221`` and ``:303`` are held in
``tests/test_torch_checkpoint_process.py``) on the same seeded
inputs through ``mpi_tpu.transport.local.run_local`` and the port's
``run_local`` with ``device="cpu"``, a rank killed by each package's
``FaultyTransport``.  The two must match on the results (bitwise), the
diagnosis (exception class, ``failed``, ``collective``, ``segment``,
error codes), the pvar counts, the membership epochs and the shrunk
ranks.  Detection is bounded by multiples of ``fault_detect_timeout_s``,
as in the reference; in-process socket worlds of both packages, with
heartbeat files, cover the socket link's peer-fault classification, and
one process world is frozen past the bound."""

import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

from mpi_tpu import errors as ref_errors
from mpi_tpu import ft as ref_ft
from mpi_tpu import mpit as ref_mpit
from mpi_tpu.communicator import P2PCommunicator as RefComm
from mpi_tpu.transport.socket import SocketTransport as RefSocket
from mpi_tpu_torch import errors, ft, mpit
from mpi_tpu_torch.communicator import P2PCommunicator
from mpi_tpu_torch.transport.socket import SocketTransport
from tests.test_torch_host_local import assert_same, seeded
from tests.test_torch_host_nbc import PORT, REF, cvars, deltas  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
DETECT_S = 0.5


@pytest.fixture(autouse=True)
def fast_detection(cvars):
    cvars("fault_detect_timeout_s", DETECT_S)
    cvars("fault_heartbeat_interval_s", 0.05)


def kill(pkg, rank, **kw):
    return lambda inner: (pkg.Faulty(inner, **kw) if inner.world_rank == rank
                          else inner)


def pkg_errors(m):
    return errors if m.port else ref_errors


def both_ft(prog, n, dead, progress="none", **kill_kw):
    """``prog`` in both packages with rank ``dead`` killed (by injection
    when ``kill_kw`` is given, else by the program itself); the survivors'
    results must be equal (bitwise for tensors)."""
    out = {}
    for pkg in (REF, PORT):
        kw = {}
        if kill_kw:
            kw["transport_wrapper"] = kill(pkg, dead, **kill_kw)
        out[pkg.port] = pkg.run(prog, n, fault_tolerance=True,
                                progress=progress, **kw)
        assert out[pkg.port][dead] is pkg.KILLED
    for r in range(n):
        if r != dead:
            assert_same(out[False][r], out[True][r], f"rank {r}")
    return out[False], out[True]


def diag(e):
    return type(e).__name__, e.failed, e.collective, e.segment


def wait_failed(c, want):
    t0 = time.monotonic()
    while c.get_failed() != want:
        assert time.monotonic() - t0 < 6 * DETECT_S
        time.sleep(0.02)


# -- detection ---------------------------------------------------------------


@pytest.mark.parametrize("progress", ["none", "thread"])
def test_detection_bound_converts_blocked_collective(progress):
    def prog(c, m):
        if c.rank == 1:
            c.allreduce(m.arr(np.ones(8)), algorithm="ring")  # dies on send 2
            return "unreachable"
        t0 = time.monotonic()
        try:
            c.allreduce(m.arr(np.ones(8)), algorithm="ring")
        except m.ProcFailedError as e:
            assert time.monotonic() - t0 < 6 * DETECT_S
            return diag(e)
        return None

    ref, got = both_ft(prog, 3, 1, progress, kill_after_n=2)
    assert got[0] == ("ProcFailedError", (1,), "allreduce", 0)


def test_detection_independent_of_recv_timeout():
    def prog(c, m):
        if c.rank == 1:
            raise _killed(m)
        assert c.recv_timeout is None
        t0 = time.monotonic()
        try:
            c.recv(source=1, tag=0)
        except m.ProcFailedError as e:
            assert time.monotonic() - t0 < 6 * DETECT_S
            return diag(e)
        return None

    ref, got = both_ft(prog, 2, 1)
    assert got[0] == ("ProcFailedError", (1,), None, None)


def _killed(m):
    """The package's KilledRankError: the in-process crash."""
    mod = sys.modules[m.Faulty.__module__]
    return mod.KilledRankError("dead on arrival")


def test_segment_named_in_segmented_collective_failure(cvars):
    cvars("collective_segment_bytes", 64)  # force multi-segment exchanges
    data = seeded(2, (256,), np.float64, seed=1)

    def prog(c, m):
        x = m.arr(data[c.rank])
        if c.rank == 1:
            c.allreduce(x, algorithm="ring")
            return "unreachable"
        try:
            c.allreduce(x, algorithm="ring")
        except m.ProcFailedError as e:
            return diag(e)
        return None

    ref, got = both_ft(prog, 2, 1, kill_after_n=3)
    assert got[0][:3] == ("ProcFailedError", (1,), "allreduce")
    assert got[0][3] is not None


# -- revocation --------------------------------------------------------------


@pytest.mark.parametrize("progress", ["none", "thread"])
def test_revoke_unblocks_rank_not_talking_to_corpse(progress):
    def prog(c, m):
        if c.rank == 1:
            c.send(b"x", 0, tag=3)  # crash_on_send_to=0: dies first
            return "unreachable"
        RevokedError = pkg_errors(m).RevokedError
        if c.rank == 2:
            out = []
            for call in (lambda: c.recv(source=0, tag=7), c.barrier):
                try:
                    call()
                except RevokedError as e:
                    out.append(type(e).__name__)
            return out
        try:
            c.recv(source=1, tag=3)
        except m.ProcFailedError as e:
            c.revoke()
            return diag(e), c.revoked
        return None

    ref, got = both_ft(prog, 3, 1, progress, crash_on_send_to=0)
    assert got[0] == (("ProcFailedError", (1,), None, None), True)
    assert got[2] == ["RevokedError", "RevokedError"]


def test_revoke_does_not_leak_across_dup():
    def prog(c, m):
        child = c.dup()
        c.barrier()
        if c.rank == 0:
            c.revoke()
        else:
            try:
                c.recv(source=0, tag=1)
            except pkg_errors(m).RevokedError:
                pass
        return child.allreduce(m.arr(np.float64(1.0)))

    for pkg in (REF, PORT):
        assert [float(v) for v in pkg.run(prog, 2, fault_tolerance=True)] == [2.0, 2.0]


# -- shrink / agree ----------------------------------------------------------


@pytest.mark.parametrize("progress", ["none", "thread"])
def test_shrink_agreement_and_post_shrink_collectives(progress):
    data = seeded(3, (4,), np.float32, seed=2)
    names = ("proc_failures_detected", "shrinks_completed")

    def prog(c, m):
        if c.rank == 1:
            raise _killed(m)
        wait_failed(c, [1])
        new = c.shrink()
        return (new.size, new.rank, c.membership_epoch,
                new.allreduce(m.arr(data[c.rank])), new.allgather(new.rank),
                new.iallreduce(m.arr(data[c.rank])).wait())

    d = {}
    for pkg in (REF, PORT):
        res, d[pkg.port] = deltas(pkg, names, lambda: pkg.run(
            prog, 3, fault_tolerance=True, progress=progress))
        if pkg.port:
            got = res
        else:
            ref = res
    for r in (0, 2):
        assert_same(ref[r], got[r], f"rank {r}")
    assert got[0][:3] == (2, 0, 1) and got[2][:3] == (2, 1, 1)
    # 2 survivors each detect the death once and complete one shrink
    assert d[True] == d[False] == {"proc_failures_detected": 2, "shrinks_completed": 2}


def test_agree_raises_until_failures_acked():
    def prog(c, m):
        if c.rank == 1:
            raise _killed(m)
        wait_failed(c, [1])
        out = []
        try:
            c.agree(True)
        except m.ProcFailedError as e:
            out.append((diag(e), e.value))
        out.append(c.failure_ack())
        out.append(c.failure_get_acked())
        out.append(c.agree(True))
        out.append(c.agree(c.rank != 0))
        return out

    ref, got = both_ft(prog, 3, 1)
    assert got[0] == [(("ProcFailedError", (1,), "agree", None), True), [1], [1],
                      True, False]


def test_nonblocking_test_and_iprobe_see_the_detector():
    def prog(c, m):
        if c.rank == 1:
            c.send(b"last words", 0, tag=5)
            raise _killed(m)
        wait_failed(c, [1])
        out = [c.irecv(source=1, tag=5).test()]  # the pre-death message
        for call in (lambda: c.irecv(source=1, tag=6).test(),
                     lambda: c.iprobe(source=1, tag=6),
                     lambda: c.improbe(source=1, tag=6)):
            try:
                call()
            except m.ProcFailedError as e:
                out.append(diag(e))
        return out

    ref, got = both_ft(prog, 2, 1)
    assert got[0][0] == (True, b"last words") and len(got[0]) == 4


def test_two_shrinks_get_distinct_contexts():
    def prog(c, m):
        if c.rank == 1:
            raise _killed(m)
        wait_failed(c, [1])
        a, b = c.shrink(), c.shrink()
        assert a._ctx != b._ctx
        return (a._ctx, b._ctx, a.allreduce(m.arr(np.float64(1.0))),
                b.allreduce(m.arr(np.float64(1.0))), c.membership_epoch)

    ref, got = both_ft(prog, 3, 1)
    assert got[0][-1] == 2  # chained world shrinks: one epoch each


# -- ERRORS_RETURN across the collective algorithm gates ---------------------

_GATES = [
    ("bcast", lambda c, m: c.bcast(m.arr(np.ones(4)), root=0)),
    ("reduce", lambda c, m: c.reduce(m.arr(np.ones(4)), root=0)),
    ("allreduce-ring", lambda c, m: c.allreduce(m.arr(np.ones(4)), algorithm="ring")),
    ("allreduce-halving", lambda c, m: c.allreduce(
        m.arr(np.ones(4)), algorithm="recursive_halving")),
    ("allreduce-rabenseifner", lambda c, m: c.allreduce(
        m.arr(np.ones(4)), algorithm="rabenseifner")),
    ("allreduce-reduce_bcast", lambda c, m: c.allreduce(
        m.arr(np.ones(4)), algorithm="reduce_bcast")),
    ("allgather-ring", lambda c, m: c.allgather(m.arr(np.ones(4)), algorithm="ring")),
    ("allgather-doubling", lambda c, m: c.allgather(m.arr(np.ones(4)),
                                                    algorithm="doubling")),
    ("alltoall", lambda c, m: c.alltoall([m.arr(np.ones(2))] * 4)),
    ("reduce_scatter", lambda c, m: c.reduce_scatter(m.arr(np.ones((4, 2))))),
    ("gather", lambda c, m: c.gather(m.arr(np.ones(2)), root=0)),
    ("scatter", lambda c, m: c.scatter(
        [m.arr(np.ones(2))] * 4 if c.rank == 0 else None, root=0)),
    ("scan", lambda c, m: c.scan(m.arr(np.ones(2)))),
    ("barrier", lambda c, m: c.barrier()),
]


@pytest.fixture(scope="module")
def gate_outcomes():
    """Every gate of ``_GATES`` under ERRORS_RETURN with rank 3 dead, in
    one world per package: each gate runs on its own ``dup`` made while
    rank 3 was alive (so no gate's leftovers reach another), after the
    detector flagged rank 3.  Returns package -> survivor outcomes by
    gate."""
    def prog(c, m):
        dups = [c.dup() for _ in _GATES]
        if c.rank == 3:
            raise _killed(m)
        wait_failed(c, [3])
        e = pkg_errors(m)
        out = {}
        for (name, call), d in zip(_GATES, dups):
            d.set_errhandler(e.ERRORS_RETURN)
            try:
                got = call(d, m)
            except Exception as exc:  # noqa: BLE001 - the handler boundary
                got = e.invoke_handler(d, exc)
            out[name] = ((int(got), type(got.exception).__name__)
                         if isinstance(got, e.ErrorCode) else "completed")
        return out

    names = ("fault_detect_timeout_s", "fault_heartbeat_interval_s")
    old = {(m, k): m.cvar_read(k) for m in (ref_mpit, mpit) for k in names}
    res = {}
    try:
        for m in (ref_mpit, mpit):
            m.cvar_write("fault_detect_timeout_s", DETECT_S)
            m.cvar_write("fault_heartbeat_interval_s", 0.05)
        for pkg in (REF, PORT):
            res[pkg.port] = pkg.run(prog, 4, fault_tolerance=True)
    finally:
        for (m, k), v in old.items():
            m.cvar_write(k, v)
    return res


@pytest.mark.parametrize("name", [g[0] for g in _GATES])
def test_errors_return_with_dead_member(name, gate_outcomes):
    """Every collective algorithm gate with a dead member under
    ERRORS_RETURN: no survivor hangs; each gets a normal completion or an
    ErrorCode of MPI_ERR_PROC_FAILED carrying ProcFailedError; at least one
    gets the error — in both packages."""
    for port in (False, True):
        outs = [gate_outcomes[port][r][name] for r in (0, 1, 2)]
        errs = [o for o in outs if o != "completed"]
        assert errs and set(errs) == {(errors.MPI_ERR_PROC_FAILED,
                                       "ProcFailedError")}, (port, outs)
    assert errors.MPI_ERR_PROC_FAILED == ref_errors.MPI_ERR_PROC_FAILED


def test_faulty_transport_counters_are_pvars():
    names = ("faulty_dropped", "faulty_duplicated")

    def prog(c, m):
        if c.rank == 0:
            for i in range(6):
                c.send(i, 1, tag=1)
            return None
        c.recv_timeout = 0.5
        got = []
        for _ in range(6):
            try:
                got.append(c.recv(source=0, tag=1))
            except Exception:  # noqa: BLE001 - a dropped message
                break
        return got

    for pkg in (REF, PORT):
        wrap = (lambda pk: lambda t: pk.Faulty(t, drop_every=3,
                                               duplicate_every=4))(pkg)
        res, d = deltas(pkg, names, lambda: pkg.run(prog, 2, transport_wrapper=wrap))
        if pkg.port:
            got, dp = res, d
        else:
            ref, dr = res, d
    assert got == ref and dp == dr and dp["faulty_dropped"] >= 1 \
        and dp["faulty_duplicated"] >= 1


def test_local_transport_rejects_link_faults():
    from mpi_tpu_torch.transport.faulty import FaultyTransport
    from mpi_tpu_torch.transport.local import LocalTransport, LocalWorld

    t = LocalTransport(LocalWorld(1, device=torch.device("cpu")), 0)
    with pytest.raises(ValueError, match="connection-level links"):
        FaultyTransport(t, link_reset_every=2)


# -- socket worlds: the link layer's peer-fault classification ----------------


def socket_ft_world(port, fn, n, dead, timeout=60.0, progress=False):
    """``fn(comm)`` on ``n`` socket transports in threads of this process
    (real TCP, heartbeat files in a fresh rendezvous dir), fault tolerant;
    rank ``dead`` is killed by its ``FaultyTransport`` and its transport
    closed, as a process death would close its sockets."""
    from mpi_tpu.transport.faulty import FaultyTransport as RefFaulty, \
        KilledRankError as RefKilled
    from mpi_tpu_torch.transport.faulty import FaultyTransport, KilledRankError

    rdv = tempfile.mkdtemp(prefix="mpi_tpu_torch_test_ft_rdv_")
    results, errs, inner = [None] * n, [], [None] * n
    Faulty, Killed = (FaultyTransport, KilledRankError) if port else (RefFaulty, RefKilled)

    def runner(r):
        try:
            t = (SocketTransport(r, n, rdv, device="cpu") if port
                 else RefSocket(r, n, rdv))
            inner[r] = t
            if r == dead:
                t = Faulty(t, kill_after_n=2)
            comm = (P2PCommunicator if port else RefComm)(t, range(n))
            comm._mark_generation()
            (ft if port else ref_ft).enable(comm, rdv_dir=rdv)
            if progress:
                from mpi_tpu import progress as ref_prog
                from mpi_tpu_torch import progress as port_prog

                (port_prog if port else ref_prog).enable(comm)
            results[r] = fn(comm)
        except Killed:
            results[r] = "killed"
            inner[r].close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            import traceback

            errs.append((r, e, traceback.format_exc()))

    threads = [threading.Thread(target=runner, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    for t in inner:
        if t is not None:
            t.close()
    if errs:
        r, e, tb = errs[0]
        raise RuntimeError(f"rank {r} failed:\n{tb}") from e
    assert not any(t.is_alive() for t in threads), "socket ranks did not finish"
    return results


@pytest.mark.parametrize("progress", [False, True])
def test_socket_peer_death_detect_revoke_shrink(progress):
    """The reference's process story in socket threads: rank 1 dies inside
    a ring allreduce (its sockets close); rank 0, blocked in the
    collective, gets ProcFailedError naming it and revokes; rank 2, blocked
    on live rank 0, gets RevokedError; both within the bound; the shrunk
    world's allreduce is bitwise and the epoch moves to 1."""
    data = seeded(3, (1 << 12,), np.float32, seed=4)

    def prog(port):
        from mpi_tpu_torch.errors import RevokedError as PRev
        from mpi_tpu.errors import RevokedError as RRev

        def fn(c):
            x = torch.from_numpy(data[c.rank].copy()) if port else data[c.rank]
            t0 = time.monotonic()
            try:
                if c.rank == 2:
                    c.recv(source=0, tag=9)
                else:
                    c.allreduce(x, algorithm="ring")
                return "completed"
            except (PRev if port else RRev):
                outcome = ("RevokedError",)
            except (errors.ProcFailedError if port else ref_errors.ProcFailedError) as e:
                outcome = ("ProcFailedError", e.failed, e.collective)
                c.revoke()
            assert time.monotonic() - t0 < 3 * DETECT_S + 8.0
            new = c.shrink()
            return outcome, new.size, c.membership_epoch, new.allreduce(x, algorithm="ring")
        return fn

    ref = socket_ft_world(False, prog(False), 3, 1, progress=progress)
    got = socket_ft_world(True, prog(True), 3, 1, progress=progress)
    assert ref[1] == got[1] == "killed"
    for r in (0, 2):
        assert_same(ref[r], got[r], f"rank {r}")
    assert got[0][:3] == (("ProcFailedError", (1,), "allreduce"), 2, 1)
    assert got[2][:3] == (("RevokedError",), 2, 1)


_FREEZE_PROG = """
import os, sys, time
import torch
import mpi_tpu_torch
from mpi_tpu_torch import mpit
from mpi_tpu_torch.errors import ProcFailedError, RevokedError

mpit.cvar_write("fault_detect_timeout_s", 2.5)
mpit.cvar_write("fault_heartbeat_interval_s", 0.2)
comm = mpi_tpu_torch.init()
BOUND = 3.0 * 2.5 + 8.0
comm.barrier()
open(os.path.join(os.environ["MPI_TPU_RDV"], f"frozen_ready.{comm.rank}"), "w").close()
t0 = time.monotonic()
try:
    for i in range(400):
        out = comm.allreduce(torch.full((512,), 1.0), algorithm="ring")
        assert float(out[0]) == float(comm.size), out[0]
        time.sleep(0.05)
    outcome = "ok"
except ProcFailedError as e:
    assert 1 in e.failed, e.failed
    assert time.monotonic() - t0 < BOUND + 20.0
    outcome = "diagnosed"
    comm.revoke()
except RevokedError:
    outcome = "diagnosed"
print(f"OUTCOME rank={comm.rank} {outcome}", flush=True)
os._exit(0)
"""


def test_freeze_past_bound_named_proc_failed(tmp_path):
    """A socket rank process paused PAST the detection bound is named:
    the survivors raise ProcFailedError (rank 1 in ``failed``) or
    RevokedError instead of healing the link to a frozen peer forever
    (``tests/test_fault_tolerance.py:698``, port processes on the CPU)."""
    script = tmp_path / "freeze.py"
    script.write_text(_FREEZE_PROG)
    rdv = tmp_path / "rdv"
    rdv.mkdir()
    procs = []
    for r in range(3):
        env = dict(os.environ, MPI_TPU_RANK=str(r), MPI_TPU_SIZE="3",
                   MPI_TPU_RDV=str(rdv), MPI_TPU_BACKEND="socket",
                   MPI_TPU_FT="1", MPI_TPU_DEVICE="cpu", PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if all((rdv / f"frozen_ready.{r}").exists() for r in range(3)):
                break
            assert all(p.poll() is None for p in procs), "a rank died at start"
            time.sleep(0.05)
        os.kill(procs[1].pid, signal.SIGSTOP)  # ... and never continued
        for r in (0, 2):
            out, err = procs[r].communicate(timeout=60.0)
            assert procs[r].returncode == 0, err[-2000:]
            assert f"OUTCOME rank={r} diagnosed" in out, (out, err[-1000:])
    finally:
        for p in procs:
            if p.poll() is None:
                os.kill(p.pid, signal.SIGCONT)
                p.kill()
                p.wait(5.0)


_LATE_PROG = """
import os, time
if os.environ["MPI_TPU_RANK"] == "2":
    time.sleep(4.0)  # a slow start: past the 2.5 s detection bound
import torch
import mpi_tpu_torch
from mpi_tpu_torch import mpit

mpit.cvar_write("fault_detect_timeout_s", 2.5)
mpit.cvar_write("fault_heartbeat_interval_s", 0.2)
comm = mpi_tpu_torch.init()
for i in range(3):
    comm.barrier()
    out = comm.allreduce(torch.full((64,), 1.0), algorithm="ring")
    assert float(out[0]) == float(comm.size), out[0]
    time.sleep(0.5)
comm.barrier()
print(f"OUTCOME rank={comm.rank} failed={sorted(comm.get_failed())}", flush=True)
mpi_tpu_torch.finalize()
"""


def test_late_starting_rank_is_not_named_failed(tmp_path):
    """One of three fault-tolerant socket rank processes starts 4 s late,
    past the 2.5 s detection bound: every barrier and allreduce completes
    and no rank names another failed, since ``init()`` starts the
    detector after the start barrier (``membership.await_incarnations``)."""
    script = tmp_path / "late.py"
    script.write_text(_LATE_PROG)
    rdv = tmp_path / "rdv"
    rdv.mkdir()
    procs = []
    for r in range(3):
        env = dict(os.environ, MPI_TPU_RANK=str(r), MPI_TPU_SIZE="3",
                   MPI_TPU_RDV=str(rdv), MPI_TPU_BACKEND="socket",
                   MPI_TPU_FT="1", MPI_TPU_DEVICE="cpu", PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=90.0)
            assert p.returncode == 0, err[-2000:]
            assert f"OUTCOME rank={r} failed=[]" in out, (out, err[-1000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5.0)


def test_start_barrier_returns_the_missing_slot_and_the_detector_names_it(tmp_path):
    """``await_incarnations`` returns at once when every slot has
    published (a rejoin); a slot that never publishes is returned as
    missing when the bound ends, and a detector started then names it
    within the detection bound while the live peer stays unnamed."""
    from mpi_tpu_torch import membership

    rdv = str(tmp_path)
    for r in (0, 1):
        membership.publish_incarnation(rdv, r)
    t0 = time.monotonic()
    assert membership.await_incarnations(rdv, 3, timeout=0.3) == [2]
    assert time.monotonic() - t0 >= 0.3
    assert membership.await_incarnations(rdv, 2, timeout=30.0) == []
    assert time.monotonic() - t0 < 5.0

    peer = ft.FileLiveness(rdv, 1)
    stop = threading.Event()

    def beat():
        while not stop.is_set():
            peer.beat(1)
            time.sleep(0.05)

    beater = threading.Thread(target=beat, daemon=True)
    beater.start()
    me = types.SimpleNamespace(world_size=3, world_rank=0)
    world = ft.WorldFT(me, ft.FileLiveness(rdv, 0), DETECT_S, 0.05)
    try:
        t0 = time.monotonic()
        while 2 not in world.failed:
            assert time.monotonic() - t0 < 6 * DETECT_S, world.failed
            time.sleep(0.02)
        assert world.failed == {2}
    finally:
        world.stop()
        stop.set()
        beater.join(5.0)
    assert not beater.is_alive()


def test_no_fallback_to_the_cpu(tmp_path):
    """Without a card and without ``device="cpu"`` the engine, the fault
    tolerant world and a joiner raise; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    import mpi_tpu_torch
    from mpi_tpu_torch import membership
    from mpi_tpu_torch.transport.local import run_local

    with pytest.raises(RuntimeError, match="device='cpu'"):
        mpi_tpu_torch.run(lambda c: 0, backend="local", nranks=2, progress="thread")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_local(lambda c: 0, 2, fault_tolerance=True)
    membership.announce_rejoin(str(tmp_path), 1, {1: {"ousted": None, "acked": False}},
                               2, "socket")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        membership.rejoin(str(tmp_path), timeout=2.0)
    assert membership.read_claim(str(tmp_path), 1, 1) is None  # raised before claiming
