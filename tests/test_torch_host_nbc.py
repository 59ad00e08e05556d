"""The port's nonblocking and persistent collectives against the
reference's: the programs of ``tests/test_nbc.py`` and
``tests/test_nbc_engine.py`` on the same seeded numpy inputs through
``mpi_tpu.transport.local.run_local`` and the port's ``run_local`` with
``device="cpu"``, on worlds with the progress engine (schedule state
machines) and without it (one thread per call).  Results are bitwise
equal, the ``nbc_*`` / ``persistent_starts`` pvar counts equal, and the
wire frame sequence ``(dst, context kind, tag, nbytes)`` of each rank —
recorded by a ``transport_wrapper`` in both packages — is the blocking
algorithm's.  Not covered here: the SPMD i-collectives (``tests/
test_nbc.py:82``, the port's since PR 1), the verifier's stalled-poll
publication (``test_nbc_engine.py:332``, ROADMAP 16.2b); the ``mpi4``
wrappers (``:301``) are held in ``tests/test_torch_mpi4.py``."""

import threading
import time

import numpy as np
import pytest
import torch

import mpi_tpu
import mpi_tpu_torch
from mpi_tpu import mpit as ref_mpit
from mpi_tpu import nbc as ref_nbc
from mpi_tpu import ops as ref_ops
from mpi_tpu.errors import ProcFailedError as RefProcFailedError
from mpi_tpu.transport.faulty import FaultyTransport as RefFaulty
from mpi_tpu.transport.local import KILLED as REF_KILLED
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import mpit, nbc, ops
from mpi_tpu_torch.errors import ProcFailedError
from mpi_tpu_torch.transport.faulty import FaultyTransport
from mpi_tpu_torch.transport.local import KILLED
from mpi_tpu_torch.transport.local import run_local as port_run_local
from tests.test_torch_host_local import assert_same, seeded, to_torch

DETECT_S = 1.0


class Pkg:
    """One package as a program sees it: its ops, error classes, fault
    injector, and how a numpy input becomes a payload."""

    def __init__(self, port: bool):
        self.port = port
        self.ops = ops if port else ref_ops
        self.mpit = mpit if port else ref_mpit
        self.nbc = nbc if port else ref_nbc
        self.ProcFailedError = ProcFailedError if port else RefProcFailedError
        self.Faulty = FaultyTransport if port else RefFaulty
        self.KILLED = KILLED if port else REF_KILLED
        self.comm_type = (mpi_tpu_torch.communicator.P2PCommunicator if port
                          else mpi_tpu.P2PCommunicator)

    def arr(self, a):
        return to_torch(a) if self.port else np.array(a)

    def run(self, prog, n, **kw):
        kw.setdefault("timeout", 60)
        if self.port:
            return port_run_local(lambda c: prog(c, self), n, device="cpu", **kw)
        return ref_run_local(lambda c: prog(c, self), n, **kw)


REF, PORT = Pkg(False), Pkg(True)


def both(prog, n, **kw):
    """Run ``prog(comm, pkg)`` in both packages; bitwise equal per rank."""
    ref = REF.run(prog, n, **kw)
    got = PORT.run(prog, n, **kw)
    for r in range(n):
        assert_same(ref[r], got[r], f"rank {r}")
    return ref, got


def deltas(pkg, names, fn):
    base = {k: pkg.mpit.pvar_read(k) for k in names}
    out = fn()
    return out, {k: pkg.mpit.pvar_read(k) - base[k] for k in names}


@pytest.fixture
def cvars():
    """Set a cvar in both packages for one test; restored after."""
    saved = []

    def write(name, value):
        for m in (ref_mpit, mpit):
            saved.append((m, name, m.cvar_read(name)))
            m.cvar_write(name, value)

    yield write
    for m, name, value in reversed(saved):
        m.cvar_write(name, value)


def ctx_kind(ctx):
    return "nbc" if isinstance(ctx, tuple) and "nbc" in ctx else repr(ctx)


def nbytes(payload):
    return int(payload.nbytes) if hasattr(payload, "nbytes") else None


def recorder(pkg, log):
    """A transport_wrapper recording every rank's sends as (dst, context
    kind, tag, nbytes), in send order."""
    class Rec(pkg.Faulty):
        def send(self, dest, ctx, tag, payload):
            with lock:
                log.setdefault(self.world_rank, []).append(
                    (dest, ctx_kind(ctx), tag, nbytes(payload)))
            super().send(dest, ctx, tag, payload)

    lock = threading.Lock()
    return lambda inner: Rec(inner)


MODES = ["thread", "none"]


# -- tests/test_nbc.py -------------------------------------------------------


@pytest.mark.parametrize("progress", MODES)
def test_two_overlapping_iallreduce_reverse_wait(progress):
    def prog(c, m):
        r1 = c.iallreduce(m.arr(np.float64(c.rank)))
        r2 = c.iallreduce(m.arr(np.float64(c.rank * 10)))
        v2 = r2.wait()
        return r1.wait(), v2

    ref, got = both(prog, 4, progress=progress)
    assert [(float(a), float(b)) for a, b in got] == [(6.0, 60.0)] * 4


@pytest.mark.parametrize("progress", MODES)
def test_ibcast_ibarrier_igather(progress):
    def prog(c, m):
        req = c.ibcast("hello" if c.rank == 0 else None, root=0)
        b = c.ibarrier()
        g = c.igather(c.rank, root=0)
        return req.wait(), b.wait(), g.wait()

    ref, got = both(prog, 4, progress=progress)
    assert got[0] == ("hello", None, [0, 1, 2, 3])


@pytest.mark.parametrize("progress", MODES)
def test_nbc_overlaps_blocking_collective(progress):
    def prog(c, m):
        req = c.iallreduce(m.arr(np.float64(1.0)))
        s = c.allreduce(m.arr(np.float64(c.rank)), op=m.ops.MAX)
        return req.wait(), s

    ref, got = both(prog, 4, progress=progress)
    assert [(float(a), float(b)) for a, b in got] == [(4.0, 3.0)] * 4


@pytest.mark.parametrize("progress", MODES)
def test_nbc_test_polls(progress):
    def prog(c, m):
        req = c.ibarrier()
        polls = 0
        while not req.test()[0]:
            polls += 1
        return True

    both(prog, 2, progress=progress)


@pytest.mark.parametrize("progress", MODES)
def test_nbc_error_surfaces_at_wait(progress):
    def prog(c, m):
        # mpilint: ok (the invalid root raises at wait(), which is the test)
        req = c.ireduce(m.arr(np.float64(1.0)), root=99)
        try:
            req.wait()
        except ValueError as e:
            return type(e).__name__, str(e)
        return None

    ref, got = both(prog, 2, progress=progress)
    assert got[0][0] == "ValueError"


def test_failed_fold_surfaces_at_wait():
    """A fold that fails on a pool worker is recorded on the machine and
    re-raised by wait(); nothing is swallowed."""
    def bad(a, b):
        raise ArithmeticError("fold failed")

    def prog(c, m):
        op = m.ops.make_op(bad, 0.0, name="bad")
        # mpilint: ok (the failing fold raises at wait(), which is the test)
        req = c.iallreduce(m.arr(np.ones(4)), op=op)
        try:
            req.wait()
        except ArithmeticError as e:
            return str(e)
        return None

    ref, got = both(prog, 2, progress="thread")
    assert got == ["fold failed"] * 2


# -- tests/test_nbc_engine.py: zero per-call threads --------------------------


def test_thousand_concurrent_iallreduce_zero_threads():
    names = ("nbc_threads_spawned", "nbc_state_machines")

    def prog(c, m):
        reqs = [c.iallreduce(m.arr(np.full(4, float(i + c.rank))))
                for i in range(1000)]
        outs = [req.wait() for req in reqs]
        return outs[::97]

    ref, dr = deltas(REF, names, lambda: REF.run(prog, 2, progress="thread",
                                                 timeout=120))
    got, dp = deltas(PORT, names, lambda: PORT.run(prog, 2, progress="thread",
                                                   timeout=120))
    for r in range(2):
        assert_same(ref[r], got[r], f"rank {r}")
    assert dp == dr == {"nbc_threads_spawned": 0, "nbc_state_machines": 2000}


def test_fold_pool_dies_with_the_engine():
    def prog(c, m):
        return c.iallreduce(m.arr(np.ones(8))).wait()

    PORT.run(prog, 2, progress="thread")
    deadline = time.time() + 5.0
    while time.time() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith("mpi-tpu-torch-nbc-fold")]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, alive


# -- parity: state machines against the thread path ---------------------------


def _family(c, m):
    p = c.size
    out = {}
    out["allreduce"] = c.iallreduce(m.arr(np.arange(8.0) + c.rank)).wait()
    out["allreduce_max"] = c.iallreduce(m.arr(np.float64(c.rank)),
                                        op=m.ops.MAX).wait()
    out["allreduce_i32"] = c.iallreduce(
        m.arr(np.arange(4, dtype=np.int32) + c.rank), op=m.ops.PROD).wait()
    out["reduce"] = c.ireduce(m.arr(np.full(3, c.rank + 1.0)), root=p - 1).wait()
    out["bcast"] = c.ibcast({"k": 1} if c.rank == 0 else None).wait()
    out["barrier"] = c.ibarrier().wait()
    out["gather"] = c.igather(c.rank * 3, root=0).wait()
    out["scatter"] = c.iscatter(
        [f"s{i}" for i in range(p)] if c.rank == 1 else None, root=1).wait()
    out["allgather"] = c.iallgather(m.arr(np.full(2, float(c.rank)))).wait()
    out["alltoall"] = c.ialltoall(
        [m.arr(np.full(2, float(c.rank * p + d))) for d in range(p)]).wait()
    out["allreduce_seeded"] = c.iallreduce(m.arr(seeded(p, (5,), seed=3)[c.rank])).wait()
    return list(out.items())


@pytest.mark.parametrize("p", [2, 3, 4])
def test_family_parity_engine_vs_thread(p):
    names = ("nbc_threads_spawned", "nbc_state_machines")
    results = {}
    for pkg in (REF, PORT):
        for mode in MODES:
            res, d = deltas(pkg, names, lambda: pkg.run(_family, p, progress=mode))
            results[(pkg.port, mode)] = res
            if mode == "thread":
                assert d["nbc_threads_spawned"] == 0, d
            else:
                assert d["nbc_threads_spawned"] > 0 and d["nbc_state_machines"] == 0
    for key, res in results.items():
        for r in range(p):
            assert_same(results[(False, "none")][r], res[r], f"{key} rank {r}")


def test_nbc_mode_thread_cvar_is_the_escape_hatch(cvars):
    cvars("nbc_mode", "thread")
    names = ("nbc_threads_spawned", "nbc_state_machines")
    ref, dr = deltas(REF, names, lambda: REF.run(_family, 3, progress="thread"))
    got, dp = deltas(PORT, names, lambda: PORT.run(_family, 3, progress="thread"))
    for r in range(3):
        assert_same(ref[r], got[r], f"rank {r}")
    assert dp == dr and dp["nbc_state_machines"] == 0 and dp["nbc_threads_spawned"] > 0


def test_size_gate_keeps_bandwidth_payloads_on_segmented_threads(cvars):
    big = 1 << 18  # 2 MiB of float64: above the 1 MiB default ceiling
    names = ("nbc_threads_spawned", "nbc_state_machines")

    def prog(c, m):
        a2a = c.ialltoall([m.arr(np.ones(big)) for _ in range(c.size)]).wait()
        return a2a[0][:4], c.iallreduce(m.arr(np.ones(big))).wait()[:4]

    for cap, want in ((None, {"nbc_threads_spawned": 4, "nbc_state_machines": 0}),
                      (0, {"nbc_threads_spawned": 0, "nbc_state_machines": 4})):
        if cap is not None:
            cvars("nbc_sm_max_bytes", cap)
        ref, dr = deltas(REF, names, lambda: REF.run(prog, 2, progress="thread"))
        got, dp = deltas(PORT, names, lambda: PORT.run(prog, 2, progress="thread"))
        for r in range(2):
            assert_same(ref[r], got[r], f"rank {r}")
        assert dp == dr == want


# -- the wire: i-collectives emit the blocking algorithm's frames -------------


def _frames(pkg, prog, n, **kw):
    log = {}
    res = pkg.run(prog, n, transport_wrapper=recorder(pkg, log), **kw)
    return res, log


@pytest.mark.parametrize("kind", ["allreduce", "ring", "rabenseifner",
                                  "reduce", "bcast", "allgather", "alltoall",
                                  "barrier", "gather", "scatter"])
def test_wire_frames_are_the_blocking_algorithms(kind):
    """Per rank, the frames an i-collective sends on the state-machine
    path equal the blocking call's (and each package's equal the other's):
    the engine adds no traffic and reorders none."""
    n = 4
    data = seeded(n, (37,), seed=5)

    def call(c, m, nonblocking):
        x = m.arr(data[c.rank])
        if kind in ("allreduce", "ring", "rabenseifner"):
            alg = "auto" if kind == "allreduce" else kind
            if nonblocking:
                return c.iallreduce(x, algorithm=alg).wait()
            return c.allreduce(x, algorithm=alg)
        if kind == "reduce":
            return (c.ireduce(x, root=2).wait() if nonblocking
                    else c.reduce(x, root=2))
        if kind == "bcast":
            v = x if c.rank == 1 else None
            return c.ibcast(v, root=1).wait() if nonblocking else c.bcast(v, root=1)
        if kind == "allgather":
            return (c.iallgather(x).wait() if nonblocking
                    else c.allgather(x, algorithm="ring"))
        if kind == "alltoall":
            blocks = [x[:9] for _ in range(n)]
            return c.ialltoall(blocks).wait() if nonblocking else c.alltoall(blocks)
        if kind == "barrier":
            return c.ibarrier().wait() if nonblocking else c.barrier()
        if kind == "gather":
            return c.igather(x, root=3).wait() if nonblocking else c.gather(x, root=3)
        objs = [x[:5]] * n if c.rank == 0 else None
        return c.iscatter(objs, root=0).wait() if nonblocking else c.scatter(objs, root=0)

    seqs = {}
    for pkg in (REF, PORT):
        for nb, mode in ((True, "thread"), (False, "none")):
            res, log = _frames(pkg, lambda c, m: call(c, m, nb), n, progress=mode)
            # the barrier's blocking signals ride their own internal tag
            seqs[(pkg.port, nb)] = (res, {
                r: [(d, t if t >= 0 else "internal", b) for d, _, t, b in f]
                for r, f in log.items()})
            kinds = {k for f in log.values() for _, k, _, _ in f}
            assert kinds == ({"nbc"} if nb else {"0"}), kinds
    ref_res, ref_frames = seqs[(False, False)]
    for key, (res, frames) in seqs.items():
        assert frames == ref_frames, key
        for r in range(n):
            assert_same(ref_res[r], res[r], f"{key} rank {r}")


# -- MPI-4 persistent collectives --------------------------------------------


@pytest.mark.parametrize("p", [2, 3])
def test_persistent_allreduce_parity_across_ops_dtypes(p):
    names = ("nbc_threads_spawned", "persistent_starts")

    def prog(c, m):
        outs = []
        for op in (m.ops.SUM, m.ops.MAX, m.ops.PROD):
            for dt in (np.float64, np.float32, np.int64):
                x = m.arr(np.arange(1, 5, dtype=dt))
                h = c.allreduce_init(x, op=op)
                for rd in range(3):
                    x[:] = m.arr(np.arange(1, 5, dtype=dt) * (rd + c.rank + 1))
                    got = h.start().wait()
                    ref = c.allreduce(x, op=op)
                    assert_same(ref, got)
                    outs.append(got.clone() if m.port else got.copy())
        return outs

    ref, dr = deltas(REF, names, lambda: REF.run(prog, p, progress="thread"))
    got, dp = deltas(PORT, names, lambda: PORT.run(prog, p, progress="thread"))
    for r in range(p):
        assert_same(ref[r], got[r], f"rank {r}")
    assert dp == dr == {"nbc_threads_spawned": 0, "persistent_starts": p * 27}


@pytest.mark.parametrize("progress", MODES)
def test_persistent_family_refire_and_engineless_fallback(progress):
    def prog(c, m):
        p = c.size
        payload = {"r": None}
        hb = c.bcast_init(payload if c.rank == 0 else None, root=0)
        blocks = m.arr(np.zeros((p, 2)))
        hrs = c.reduce_scatter_init(blocks)
        objs = [None] * p
        ha = c.alltoall_init(objs)
        rounds = []
        for rd in range(3):
            payload["r"] = rd          # bcast re-reads the bound CONTENT
            blocks[:] = rd + c.rank    # refilled in place
            objs[:] = [(c.rank, d, rd) for d in range(p)]
            b = hb.start().wait()
            rs = hrs.start().wait()
            a = ha.start().wait()
            rounds.append((b, rs.clone() if m.port else rs.copy(), a))
        return rounds

    ref, got = both(prog, 3, progress=progress)
    assert float(got[1][2][1][0]) == sum(2 + r for r in range(3))


@pytest.mark.parametrize("progress", MODES)
def test_persistent_size1_refire_reads_bound_buffer(progress):
    def prog(c, m):
        x = m.arr(np.ones(4))
        h = c.allreduce_init(x)
        a = float(h.start().wait()[0])
        x[:] = 5.0
        return a, float(h.start().wait()[0])

    ref, got = both(prog, 1, progress=progress)
    assert got == [(1.0, 5.0)]


def test_persistent_ragged_reduce_scatter_init_falls_back():
    def prog(c, m):
        blocks = [m.arr(np.full(2 + d, float(c.rank + 1))) for d in range(c.size)]
        h = c.reduce_scatter_init(blocks)
        outs = []
        for rd in range(2):
            for d in range(c.size):
                blocks[d][:] = c.rank + 1 + rd
            outs.append(h.start().wait())
        return outs

    both(prog, 2, progress="thread")


def test_persistent_geometry_bound_and_start_discipline():
    def prog(c, m):
        out = []
        h = c.allreduce_init(m.arr(np.ones(4)))
        try:
            h.wait()
        except RuntimeError as e:
            out.append(str(e))
        h.start()
        h.wait()
        h2 = c.allreduce_init(m.arr(np.ones(4)))
        h2._args = (m.arr(np.ones(5)),)  # rebound: the geometry changed
        try:
            h2.start()
        except ValueError as e:
            out.append("geometry" in str(e))
        h2._args = (m.arr(np.ones(4)),)  # the peers compiled for n = 4
        out.append(h2.start().wait())
        return out

    ref, got = both(prog, 2, progress="thread")
    assert got[0][1] is True


def test_persistent_handles_are_engine_owned():
    """``*_init`` returns the engine-owned handle in both packages (the
    generic ``mpi4`` wrappers around them: ``tests/test_torch_mpi4.py``)."""
    def prog(c, m):
        h = c.allreduce_init(m.arr(np.ones(4)))
        assert isinstance(h, m.nbc.PersistentColl), type(h)
        return h.start().wait()

    both(prog, 2, progress="thread")


def test_persistent_round_reads_the_buffer_each_start():
    """The buffer-reuse idiom on the port: a tensor refilled IN PLACE
    between starts is folded afresh (no copy is cached at init), and the
    wire carries the same frames every round."""
    log = {}

    def prog(c, m):
        x = torch.zeros(6)
        h = c.allreduce_init(x, algorithm="ring")
        outs = []
        for rd in range(4):
            x.copy_(torch.arange(6.0) * (rd + 1) + c.rank)
            outs.append(h.start().wait().clone())
        return outs

    got = port_run_local(lambda c: prog(c, PORT), 3, device="cpu",
                         progress="thread", timeout=60,
                         transport_wrapper=recorder(PORT, log))
    for rd in range(4):
        assert torch.equal(got[0][rd], torch.arange(6.0) * (rd + 1) * 3 + 3)
    per_round = len(log[0]) // 4
    assert log[0] == log[0][:per_round] * 4


def test_ft_kill_mid_persistent_diagnosed_in_bound(cvars):
    cvars("fault_detect_timeout_s", DETECT_S)
    cvars("fault_heartbeat_interval_s", 0.05)

    def prog(c, m):
        h = c.allreduce_init(m.arr(np.ones(1 << 10)), algorithm="ring")
        h.start()  # rank 1 dies inside this round's sends
        if c.rank == 1:
            return h.wait()  # re-raises its own KilledRankError
        t0 = time.monotonic()
        try:
            h.wait()
        except m.ProcFailedError as e:
            assert time.monotonic() - t0 < 6 * DETECT_S
            return type(e).__name__, e.failed, e.collective
        return None

    out = {}
    for pkg in (REF, PORT):
        wrap = (lambda pk: lambda inner: (pk.Faulty(inner, kill_after_n=2)
                                          if inner.world_rank == 1 else inner))(pkg)
        out[pkg.port] = pkg.run(prog, 3, transport_wrapper=wrap,
                                fault_tolerance=True, progress="thread")
        assert out[pkg.port][1] is pkg.KILLED
    for r in (0, 2):
        assert out[True][r] == out[False][r] == ("ProcFailedError", (1,), "iallreduce")
