"""The port's runtime verifier against the reference's: the programs of
``tests/test_verify.py`` (and of the verifier tests of
``tests/test_progress.py``, ``tests/test_nbc_engine.py`` and
``tests/test_recvpool.py``) on the same seeded numpy inputs through
``mpi_tpu.transport.local.run_local(..., verify=True)`` and
``mpi_tpu_torch.run(..., backend="local", device="cpu", verify=True)``
with ``torch.from_numpy`` of the same arrays.  Each seeded bug raises the
same exception class with equal ``.ranks`` and the same rendered
diagnosis apart from call sites; each lint gives the same report-line
kinds and ``verify_*`` pvar deltas; clean programs give equal results and
empty reports.  The FileBoard tests drive both packages' boards in
lockstep.  The process worlds (the cross-process deadlock, and the
wildcard race over the socket and shm transports, the sm arena clean
under the verifier) run the port's launcher.  The compressed-signature
tests (``tests/test_verify.py:1074-1150``) hold the resolved wire name and
top-k's k in the signature.

Not written: the ``bench.py --verify-overhead`` leg (the benchmark
folder is not ported)."""

import gc
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mpi_tpu_torch
from mpi_tpu import checker as ref_checker
from mpi_tpu import errors as ref_errors
from mpi_tpu import mpit as ref_mpit
from mpi_tpu import ops as ref_ops
from mpi_tpu import trace as ref_trace
from mpi_tpu import verify as ref_verify
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu.verify.state import FileBoard as RefFileBoard
from mpi_tpu_torch import checker, errors, ft, mpit, ops, trace, verify
from mpi_tpu_torch import communicator as comm_mod
from mpi_tpu_torch.verify.state import FileBoard
from tests.test_torch_host_local import assert_same, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALL = 0.4  # tight stall bound: deadlock tests converge in about a second


class Pkg:
    """One package as a verified program sees it."""

    def __init__(self, port: bool):
        self.port = port
        self.mpit = mpit if port else ref_mpit
        self.verify = verify if port else ref_verify
        self.errors = errors if port else ref_errors
        self.ops = ops if port else ref_ops
        self.checker = checker if port else ref_checker
        self.trace = trace if port else ref_trace
        self.FileBoard = FileBoard if port else RefFileBoard

    def arr(self, a):
        return to_torch(np.asarray(a)) if self.port else np.array(a)

    def zeros(self, n):
        return torch.zeros(n, dtype=torch.float64) if self.port else np.zeros(n)

    def run(self, prog, n, **kw):
        kw.setdefault("verify", True)
        if self.port:
            return mpi_tpu_torch.run(lambda c: prog(c, self), backend="local",
                                     nranks=n, device="cpu", **kw)
        return ref_run_local(lambda c: prog(c, self), n, timeout=60, **kw)


REF, PORT = Pkg(False), Pkg(True)
PKGS = [REF, PORT]


@pytest.fixture(autouse=True)
def _fast_stall_and_clean_report():
    saved = [(m, m.mpit.cvar_read("verify_stall_timeout_s")) for m in PKGS]
    for m in PKGS:
        m.mpit.cvar_write("verify_stall_timeout_s", STALL)
    gc.collect()
    for m in PKGS:
        m.verify.finalize_report()  # drain leftovers from earlier tests
    yield
    for m, old in saved:
        m.mpit.cvar_write("verify_stall_timeout_s", old)
    gc.collect()
    for m in PKGS:
        m.verify.finalize_report()


_SITE = re.compile(r"(at |\[)(/\S+|<[^>]+>):\d+")


def _render(msg: str) -> str:
    """A diagnosis with every call site blanked."""
    return _SITE.sub(r"\1<site>", msg)


_KINDS = ("leaked request", "double-wait", "overlapping live buffers",
          "wildcard race", "never freed", "deadlock detected",
          "collective mismatch")


def _kind(line: str) -> str:
    return next((k for k in _KINDS if k in line), line)


def _verify_pvars(m):
    return [p for p in m.mpit.pvar_list()
            if p.startswith("verify_") and p != "verify_clock_bytes"]


class Outcome:
    def __init__(self, m, prog, n, **kw):
        ses = m.mpit.session_create()
        ses.reset_all()
        self.cause = None
        self.results = None
        t0 = time.monotonic()
        try:
            self.results = m.run(prog, n, **kw)
        except RuntimeError as e:
            self.cause = e.__cause__
        self.seconds = time.monotonic() - t0
        # sweep the live worlds first (their registry is weakly held),
        # then collect: a request dropped unwaited reports at its GC
        self.report = m.verify.finalize_report()
        gc.collect()
        self.report += m.verify.take_report()
        self.pvars = {p: ses.read(p) for p in _verify_pvars(m)}
        self.clock_bytes = ses.read("verify_clock_bytes")


def both(prog, n=2, **kw):
    return Outcome(REF, prog, n, **kw), Outcome(PORT, prog, n, **kw)


def assert_same_diagnosis(ref, got):
    assert type(got.cause).__name__ == type(ref.cause).__name__, \
        (got.cause, ref.cause)
    assert sorted(got.cause.ranks) == sorted(ref.cause.ranks)
    assert _render(str(got.cause)) == _render(str(ref.cause))
    assert "test_torch_verify.py" in str(got.cause)  # the call sites
    assert got.seconds < 20.0, f"diagnosis took {got.seconds:.1f}s"
    return got.cause


def assert_same_lints(ref, got):
    assert sorted(map(_kind, got.report)) == sorted(map(_kind, ref.report))
    assert got.pvars == ref.pvars
    return got.report


# -- deadlock detection ------------------------------------------------------


def _cross_recv(c, m):
    if c.rank == 0:
        c.recv(source=1, tag=7)  # blocks forever: 1 never sends
        c.send(m.arr([1.0]), 1, tag=7)
    else:
        c.recv(source=0, tag=7)
        c.send(m.arr([2.0]), 0, tag=7)


def _exited(c, m):
    if c.rank == 0:
        c.recv(source=1, tag=3)  # rank 1 exits without sending


def _knot(c, m):
    if c.rank == 0:
        c.recv(source=-1, tag=1)  # OR over {1}; 1 is AND on 0
    else:
        c.recv(source=0, tag=2)


def _wrong_tag(c, m):
    c.send(m.arr([float(c.rank)]), 1 - c.rank, tag=5)  # mpilint: ok
    c.recv(source=1 - c.rank, tag=6)  # mpilint: ok


@pytest.mark.parametrize("prog,expect", [
    (_cross_recv, ["recv(source=1, tag=7)", "recv(source=0, tag=7)"]),
    (_exited, ["exited"]),
    (_knot, []),
    (_wrong_tag, ["unmatched message"]),
], ids=["cross_send", "wait_on_exited", "any_source_knot", "wrong_tag"])
def test_deadlock_diagnosis_is_the_references(prog, expect):
    ref, got = both(prog)
    cause = assert_same_diagnosis(ref, got)
    assert isinstance(cause, errors.DeadlockError)
    for text in expect:
        assert text in str(cause)
    assert got.pvars["verify_deadlocks_detected"] >= 1
    assert ref.pvars["verify_deadlocks_detected"] >= 1
    assert errors.error_class(cause) == errors.MPI_ERR_PENDING


def test_live_peer_prevents_false_positive():
    """OR semantics: one computing peer keeps the picture open and the
    message lands."""
    def live(c, m):
        if c.rank == 0:
            return float(c.recv(source=-1, tag=1)[0])  # mpilint: ok
        time.sleep(3 * STALL)
        c.send(m.arr([7.0]), 0, tag=1)

    ref, got = both(live)
    assert ref.results[0] == got.results[0] == 7.0
    assert got.pvars == ref.pvars and not any(got.pvars.values())


_DEADLOCK_CASES = [
    ({0: ("AND", [1]), 1: ("AND", [0])}, 2, ()),
    ({0: ("AND", [1]), 1: ("AND", [0])}, 3, ()),
    ({0: ("AND", [2])}, 3, ()),
    ({0: ("OR", [1, 2]), 1: ("AND", [0])}, 3, ()),
    ({0: ("OR", [1, 2]), 1: ("AND", [0]), 2: ("AND", [1])}, 3, ()),
    ({0: ("AND", [1])}, 2, (1,)),
    ({0: ("AND", [1, 2]), 1: ("AND", [0])}, 3, ()),
    ({0: ("AND", [])}, 2, ()),
]


@pytest.mark.parametrize("waits,size,exited", _DEADLOCK_CASES)
def test_find_deadlock_is_the_references(waits, size, exited):
    got = checker.find_deadlock(waits, range(size), exited=exited)
    assert got == ref_checker.find_deadlock(waits, range(size), exited=exited)


def test_checker_matching_and_rounds_are_the_references():
    logs = [[("send", 1, 3), ("send", 1, 4), ("recv", 1, 9)],
            [("recv", 0, 4), ("recv", 0, 3)]]
    for strict in (True, False):
        assert checker.verify_matching(logs, strict_fifo=strict) == \
            ref_checker.verify_matching(logs, strict_fifo=strict)
    with pytest.raises(checker.ScheduleError, match="round 1"):
        checker.validate_rounds([[(0, 1)], [(0, 1), (0, 2)]], 3)


def test_poll_slice_matches_ft():
    assert comm_mod._FT_POLL_S == ft.POLL_S


# -- collective matching -----------------------------------------------------


def _order(c, m):
    if c.rank == 0:
        c.bcast(m.arr([1.0]), root=0)  # mpilint: ok (deliberate divergence)
    else:
        c.allreduce(m.arr(np.ones(2)))  # mpilint: ok


def _root(c, m):
    c.bcast(m.arr(np.ones(2)), root=c.rank)


def _geometry(c, m):
    c.allreduce(m.arr(np.ones(8 if c.rank == 0 else 4, np.float32)))


def _op(c, m):
    c.allreduce(m.arr(np.ones(4)), op=m.ops.SUM if c.rank == 0 else m.ops.MAX)


def _dtype(c, m):
    c.allreduce(m.arr(np.ones(4, np.float32 if c.rank == 0 else np.float64)))


def _counts(c, m):
    counts = [2, 2] if c.rank == 0 else [2, 1]
    return c.allgatherv(m.arr(np.ones((2, 3))), counts)


def _count_divergence(c, m):
    c.barrier()
    if c.rank == 0:
        c.barrier()  # mpilint: ok (deliberate divergence)


@pytest.mark.parametrize("prog,cls,expect", [
    (_order, "CollectiveMismatchError", ["bcast", "allreduce"]),
    (_root, "CollectiveMismatchError", ["root=0", "root=1"]),
    (_geometry, "CollectiveMismatchError", ["(8,)", "(4,)", "'float32'"]),
    (_op, "CollectiveMismatchError", ["op=sum", "op=max"]),
    (_dtype, "CollectiveMismatchError", ["'float32'", "'float64'"]),
    (_counts, "CollectiveMismatchError", ["counts=[2, 2]", "counts=[2, 1]"]),
    (_count_divergence, "DeadlockError", ["barrier"]),
], ids=["order", "root", "geometry", "op", "dtype", "allgatherv_counts",
        "count_divergence"])
def test_collective_mismatch_is_the_references(prog, cls, expect):
    ref, got = both(prog)
    cause = assert_same_diagnosis(ref, got)
    assert type(cause).__name__ == cls
    for text in expect:
        assert text in str(cause)
    if cls == "CollectiveMismatchError":
        assert len(cause.signatures) == 2 and len(cause.sites) == 2
        assert cause.signatures == ref.cause.signatures
        assert got.pvars["verify_collective_mismatches"] >= 1
        assert errors.error_class(cause) == errors.MPI_ERR_OTHER


def test_mismatch_raises_before_collective_data_moves():
    """A large allreduce against a bcast: only the signature tuples
    travel — no rank's bytes_sent grows by a payload."""
    def prog(c, m):
        if c.rank == 0:
            c.allreduce(m.arr(np.ones(1 << 16, np.float32)))  # mpilint: ok
        else:
            c.bcast(m.arr(np.ones(1 << 16, np.float32)))  # mpilint: ok

    base = mpit.pvar_read("bytes_sent")
    got = Outcome(PORT, prog, 2)
    assert isinstance(got.cause, errors.CollectiveMismatchError)
    assert mpit.pvar_read("bytes_sent") - base < (1 << 16) * 4


# -- request / buffer / comm lints -------------------------------------------


def _leaks(c, m):
    if c.rank == 0:
        c.isend(m.arr(np.ones(4)), 1, tag=3)  # mpilint: ok (never waited)
        c.recv(source=1, tag=5)
    else:
        c.send(m.arr([1.0]), 0, tag=5)
        c.irecv(source=0, tag=3)  # mpilint: ok (never waited)
    gc.collect()


def _double_wait(c, m):
    if c.rank == 0:
        c.send(m.arr(np.ones(2)), 1, tag=1)
    else:
        r = c.irecv(source=0, tag=1)
        r.wait()
        r.wait()  # second wait on a completed request


def _recv_init_overlap(c, m, lo=2, hi=6):
    buf = m.zeros(8)
    peer = 1 - c.rank
    r1 = c.recv_init(source=peer, tag=2, buf=buf).start()
    r2 = c.recv_init(source=peer, tag=2, buf=buf[lo:hi]).start()
    c.send(m.arr(np.arange(8.0)), peer, tag=2)
    c.send(m.arr(np.arange(4.0)), peer, tag=2)
    r1.wait()
    r2.wait()


def _recv_init_disjoint(c, m):
    buf = m.zeros(8)
    peer = 1 - c.rank
    r1 = c.recv_init(source=peer, tag=2, buf=buf[:4]).start()
    r2 = c.recv_init(source=peer, tag=2, buf=buf[4:]).start()
    c.send(m.arr(np.arange(4.0)), peer, tag=2)
    c.send(m.arr(np.arange(4.0) + 4), peer, tag=2)
    r1.wait()
    r2.wait()
    return float(buf.sum())


def _irecv_buf(overlap):
    def prog(c, m):
        buf = m.zeros(8)
        peer = 1 - c.rank
        r1 = c.irecv(source=peer, tag=4, buf=buf[0:4])
        r2 = c.irecv(source=peer, tag=4, buf=buf[2:6] if overlap else buf[4:8])
        c.send(m.arr(np.arange(4.0)), peer, tag=4)
        c.send(m.arr(np.arange(4.0) + 4), peer, tag=4)
        r1.wait()
        r2.wait()
        return float(buf.sum())
    return prog


def _strided_views(c, m):
    """Interleaved views (even and odd elements) reach the same bytes
    range but never the same element: the lint is range-based, as the
    reference's array-interface spans are."""
    buf = m.zeros(8)
    peer = 1 - c.rank
    r1 = c.irecv(source=peer, tag=4, buf=buf[0::2])
    r2 = c.irecv(source=peer, tag=4, buf=buf[1::2])
    c.send(m.arr(np.arange(4.0)), peer, tag=4)
    c.send(m.arr(np.arange(4.0) + 4), peer, tag=4)
    r1.wait()
    r2.wait()
    return float(buf.sum())


def _unfreed(c, m):
    sub = c.split(0)
    sub.barrier()


def _freed(c, m):
    sub = c.dup()
    sub.barrier()
    sub.free()


def _isendrecv_replace(c, m):
    buf = m.zeros(4) + c.rank
    r = c.isendrecv_replace(buf, 1 - c.rank, source=1 - c.rank)
    r2 = c.irecv(source=1 - c.rank, tag=8, buf=buf[1:3])
    c.send(m.arr(np.ones(2)), 1 - c.rank, tag=8)
    r.wait()
    r2.wait()


@pytest.mark.parametrize("prog,kinds", [
    (_leaks, ["leaked request"] * 2),
    (_double_wait, ["double-wait"]),
    (_recv_init_overlap, ["overlapping live buffers"] * 2),
    (_recv_init_disjoint, []),
    (_irecv_buf(True), ["overlapping live buffers"] * 2),
    (_irecv_buf(False), []),
    (_strided_views, ["overlapping live buffers"] * 2),
    (_unfreed, ["never freed"] * 2),
    (_freed, []),
    (_isendrecv_replace, ["overlapping live buffers"] * 2),
], ids=["leaked", "double_wait", "recv_init_overlap", "recv_init_disjoint",
        "irecv_buf_overlap", "irecv_buf_disjoint", "strided_views",
        "unfreed_comm", "freed_comm", "isendrecv_replace"])
def test_lints_are_the_references(prog, kinds):
    ref, got = both(prog)
    assert ref.cause is None and got.cause is None, (ref.cause, got.cause)
    report = assert_same_lints(ref, got)
    assert sorted(map(_kind, report)) == sorted(kinds)
    if ref.results[0] is not None:
        assert got.results == ref.results
    for line in report:
        assert "test_torch_verify.py" in line or "never freed" not in line


def test_leak_lines_name_rank_op_peer_tag():
    got = Outcome(PORT, _leaks, 2)
    leaks = [r for r in got.report if "leaked request" in r]
    assert any("isend(peer=1, tag=3)" in r and "rank 0" in r for r in leaks)
    assert any("irecv(peer=0, tag=3)" in r and "rank 1" in r for r in leaks)


def test_waited_requests_not_reported():
    def prog(c, m):
        peer = 1 - c.rank
        req = c.irecv(source=peer, tag=2)
        c.isend(m.arr([float(c.rank)]), peer, tag=2).wait()
        return float(req.wait()[0])

    ref, got = both(prog)
    assert ref.results == got.results == [1.0, 0.0]
    assert got.report == ref.report == []


# -- clean programs produce no diagnostics -----------------------------------


def _family(c, m):
    r, p = c.rank, c.size
    out = [c.bcast(m.arr(np.arange(4.0)), root=0),
           c.allreduce(m.arr(np.float64(r + 1)), op=m.ops.SUM),
           c.allgather(m.arr(np.full(2, r)))[r]]
    red = c.reduce(m.arr(np.ones(3)), root=1)
    out.append(red if r == 1 else None)
    c.barrier()
    out.append(c.alltoall([m.arr(np.full(1, r * p + d)) for d in range(p)]))
    out.append(c.scan(m.arr(np.ones(2))))
    out.append(c.reduce_scatter(m.arr(np.ones((p, 2)))))
    out.append(c.sendrecv(m.arr([float(r)]), (r + 1) % p, (r - 1) % p, 9, 9))
    c.ibarrier().wait()
    out.append(c.iallreduce(m.arr(np.arange(3.0) * r)).wait())
    return out


@pytest.mark.parametrize("progress", ["none", "thread"])
def test_clean_program_full_collective_family(progress):
    ref, got = both(_family, 3, progress=progress)
    assert ref.cause is None and got.cause is None, (ref.cause, got.cause)
    for r in range(3):
        assert_same(ref.results[r], got.results[r], f"rank {r}")
    assert got.report == ref.report == []
    assert not any(got.pvars.values()) and not any(ref.pvars.values())
    assert got.clock_bytes == ref.clock_bytes > 0  # the clocks ran


def test_clean_segmented_engine_under_verify():
    saved = [(m, m.mpit.cvar_read("collective_segment_bytes")) for m in PKGS]
    for m in PKGS:
        m.mpit.cvar_write("collective_segment_bytes", 64)
    try:
        def prog(c, m):
            arr = np.arange(256.0) + c.rank
            return (c.allreduce(m.arr(arr), algorithm="ring"),
                    c.allreduce(m.arr(arr), algorithm="rabenseifner"),
                    c.reduce_scatter(m.arr(np.tile(arr, (c.size, 1)) + c.rank)))

        ref, got = both(prog)
    finally:
        for m, old in saved:
            m.mpit.cvar_write("collective_segment_bytes", old)
    for r in range(2):
        assert_same(ref.results[r], got.results[r], f"rank {r}")
    assert got.report == ref.report == []


def test_verify_with_fault_tolerance_coexists():
    def prog(c, m):
        return float(c.allreduce(m.arr(np.ones(8))).sum())

    ref, got = both(prog, fault_tolerance=True)
    assert ref.results == got.results == [16.0, 16.0]
    assert got.report == []


def test_verify_run_runtime_verify_fold():
    def clean(c, m):
        peer = 1 - c.rank
        c.send(m.arr([float(c.rank)]), peer, tag=1)  # mpilint: ok
        return float(c.recv(source=peer, tag=1)[0])

    def leaky(c, m):
        c.send(m.arr([float(c.rank)]), 1 - c.rank, tag=1)  # never received
        gc.collect()

    for prog, want in ((clean, [1.0, 0.0]), (leaky, [None, None])):
        ref = ref_trace.verify_run(lambda c: prog(c, REF), 2,
                                   runtime_verify=True)
        got = trace.verify_run(lambda c: prog(c, PORT), 2,
                               runtime_verify=True, device="cpu")
        assert got[0] == ref[0] == want
        assert got[1] == ref[1]
    assert any("never received" in p for p in got[1])


# -- off-mode zero cost ------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["ring", "rabenseifner"])
def test_verify_off_leaves_hot_path_pvar_contracts(algorithm):
    """verify off: 0 pickled array bytes, the engine's exact
    payload_copies (the reference's), no verify machinery at all."""
    out = []
    for m in PKGS:
        ses = m.mpit.session_create()
        ses.reset_all()
        m.run(lambda c, mm: c.allreduce(mm.arr(np.ones(1 << 12, np.float32)),
                                        algorithm=algorithm), 2, verify=False)
        assert ses.read("bytes_pickled_sent") == 0
        for p in m.mpit.pvar_list():
            if p.startswith("verify_") or p == "trace_events":
                assert ses.read(p) == 0, p
        out.append(ses.read("payload_copies"))
    assert out[1] == out[0]


def test_verify_on_keeps_the_wire_accounting():
    """verify on: the stamps ride the envelope, never the payload — 0
    pickled bytes and the same payload_copies as verify off."""
    def prog(c, m):
        return c.allreduce(m.arr(np.ones(1 << 12, np.float32)),
                           algorithm="ring")

    counts = []
    for flag in (False, True):
        ses = mpit.session_create()
        ses.reset_all()
        PORT.run(prog, 2, verify=flag)
        counts.append((ses.read("bytes_pickled_sent"),
                       ses.read("payload_copies")))
    assert counts[0] == counts[1] == (0, counts[0][1])


def test_verify_off_requests_untracked():
    def prog(c, m):
        if c.rank == 0:
            c.isend(m.arr([1.0]), 1, tag=0)  # mpilint: ok (verify off)
        else:
            c.irecv(source=0, tag=0)  # mpilint: ok
        gc.collect()

    PORT.run(prog, 2, verify=False)
    gc.collect()
    assert verify.finalize_report() == []


def test_verify_needs_the_card_or_cpu():
    """No fallback: a verified local world without ``device="cpu"`` needs
    the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        mpi_tpu_torch.run(lambda c: 0, backend="local", nranks=2, verify=True)


def test_stall_cvar_validates():
    with pytest.raises(ValueError, match="verify_stall_timeout_s"):
        mpit.cvar_write("verify_stall_timeout_s", 0)
    assert "verify_stall_timeout_s" in mpit.cvar_list()


# -- wildcard-race detection -------------------------------------------------


def _race(c, m):
    if c.rank == 0:
        while not (c.iprobe(source=1, tag=7) and c.iprobe(source=2, tag=7)):
            time.sleep(0.001)
        a = c.recv(source=-1, tag=7)  # mpilint: ok
        b = c.recv(source=-1, tag=7)  # mpilint: ok
        return sorted([float(a[0]), float(b[0])])
    c.send(m.arr([float(c.rank)]), 0, tag=7)


def _race_line(line: str) -> str:
    """A race line with its site blanked and its two senders in rank
    order: which of two concurrent messages matched first is the
    nondeterminism the line reports."""
    pair = re.compile(r"from rank (\d+) while a CONCURRENT message from rank (\d+)")
    return pair.sub(lambda mt: "from ranks {} and {}".format(
        *sorted(mt.groups())), _render(line))


def _ordered(c, m):
    if c.rank == 0:
        a = c.recv(source=-1, tag=9)  # mpilint: ok
        b = c.recv(source=-1, tag=9)  # mpilint: ok
        return sorted([float(a[0]), float(b[0])])
    if c.rank == 1:
        c.send(m.arr([1.0]), 0, tag=9)
        c.send(m.arr([0.0]), 2, tag=1)
    else:
        c.recv(source=1, tag=1)  # happens-before: m2's send is after m1's
        c.send(m.arr([2.0]), 0, tag=9)


@pytest.mark.parametrize("prog,races", [(_race, 1), (_ordered, 0)],
                         ids=["concurrent_senders", "ordered_senders"])
def test_wildcard_race_is_the_references(prog, races):
    ref, got = both(prog, 3)
    assert ref.results[0] == got.results[0] == [1.0, 2.0]
    assert got.pvars["verify_wildcard_races"] == \
        ref.pvars["verify_wildcard_races"] == races
    lines = [ln for ln in got.report if "wildcard race" in ln]
    assert [_race_line(ln) for ln in lines] == \
        [_race_line(ln) for ln in ref.report if "wildcard race" in ln]
    if races:
        assert "from rank 1" in lines[0] and "rank 2" in lines[0]
        assert "tag=7" in lines[0] and "test_torch_verify.py" in lines[0]
    assert got.clock_bytes == ref.clock_bytes > 0


# -- the progress engine as the blocking waiter of polling loops -------------


def _drain_loop(c, m, give_up_s):
    req = c.irecv((c.rank + 1) % c.size, tag=3)  # mpilint: ok (no sender)
    deadline = time.time() + give_up_s
    try:
        while time.time() < deadline:
            done, _ = req.test()
            if done:
                return "completed"
            time.sleep(0.001)
        return "no-detection"
    except m.errors.DeadlockError as e:
        assert len(e.ranks) == c.size
        return "deadlocked"


@pytest.mark.parametrize("progress,want,give_up_s", [
    ("thread", "deadlocked", 4.0), ("none", "no-detection", 2.0)])
def test_polling_loop_deadlock_is_the_references(progress, want, give_up_s):
    for m in PKGS:
        m.mpit.cvar_write("verify_stall_timeout_s", 1.0)
    prog = lambda c, m: _drain_loop(c, m, give_up_s)  # noqa: E731
    ref, got = both(prog, progress=progress)
    assert ref.results == got.results == [want, want]
    assert (got.pvars["verify_deadlocks_detected"] > 0) == \
        (ref.pvars["verify_deadlocks_detected"] > 0) == (want == "deadlocked")


def test_slow_peer_never_false_positives():
    for m in PKGS:
        m.mpit.cvar_write("verify_stall_timeout_s", 1.0)

    def prog(c, m):
        if c.rank == 0:
            time.sleep(2.5)  # well past the stall bound
            c.send(m.arr([5.0]), 1, tag=2)
            return 0.0
        req = c.irecv(0, 2)  # mpilint: ok
        while True:
            done, v = req.test()
            if done:
                return float(v[0])
            time.sleep(0.001)

    got = Outcome(PORT, prog, 2, progress="thread")
    assert got.results == [0.0, 5.0]
    assert got.pvars["verify_deadlocks_detected"] == 0


def test_sm_poll_publishes_exact_per_call_or_set():
    """The engine publishes the polled state machine's own pending
    sources: rank 0's ring allreduce pends only on its left neighbour
    (rank 2), not on the unrelated tracked irecv from rank 1."""
    for m in PKGS:
        m.mpit.cvar_write("verify_stall_timeout_s", 1.0)

    def prog(c, m):
        h = c.allreduce_init(m.arr(np.ones(4)), algorithm="ring")
        if c.rank == 0:
            stray = c.irecv(1, tag=9)  # tracked, never polled
            h.start()
            entry, deadline = None, time.time() + 8.0
            while time.time() < deadline:
                done, _ = h.test()
                if done:
                    break
                e = c._verify.world.board.read_all().get(c.rank)
                if e and e.get("kind") == "waitany-poll":
                    entry = dict(e)
                    break
                time.sleep(0.002)
            out = h.wait()
            return entry, float(out[0]), float(stray.wait()[0])
        time.sleep(2.5)  # long enough for rank 0's episode to publish
        if c.rank == 1:
            c.send(m.arr([9.0]), 0, tag=9)
        return float(h.start().wait()[0])

    got = Outcome(PORT, prog, 3, progress="thread")
    entry, val, stray = got.results[0]
    assert (val, stray) == (3.0, 9.0)
    assert got.results[1] == got.results[2] == 3.0
    assert entry is not None, "stalled state-machine poll never published"
    assert entry["targets"] == [2] and entry["mode"] == "OR"
    assert entry["coll"] == "iallreduce"


# -- the persistent collectives' double-buffer fence -------------------------


def _fenced(kind):
    def prog(c, m):
        if kind == "allreduce":
            h = c.allreduce_init(m.arr(np.ones(16)))
        else:
            h = c.reduce_scatter_init([m.arr(np.ones(8)) for _ in range(2)])
        r0 = h.start().wait()  # round 0 result, kept alive
        h.start().wait()
        try:
            h.start().wait()  # round 2 would overwrite r0
        except m.errors.BufferPinnedError as e:
            return ("fenced", "copy it first" in str(e), float(r0[0]))
        return ("missed", False, float(r0[0]))
    return prog


@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter"])
def test_persistent_fence_is_the_references(kind):
    ref, got = both(_fenced(kind), progress="thread")
    assert ref.results == got.results == [("fenced", True, 2.0)] * 2


def test_persistent_fence_tracks_the_result_object():
    """The fence pins the round RESULT object (itself a view of the
    double buffer): a caller that keeps only a view OF that result does
    not trip it, in the reference as in the port (it weakly references
    the result, not its views)."""
    def prog(c, m):
        h = c.allreduce_init(m.arr(np.ones(16)))
        view = h.start().wait()[4:8]  # keep only a view of round 0
        h.start().wait()
        try:
            h.start().wait()
        except m.errors.BufferPinnedError:
            return "fenced", float(view[0])
        return "missed", float(view[0])

    ref, got = both(prog, progress="thread")
    assert got.results == ref.results
    assert [r[0] for r in got.results] == ["missed", "missed"]


def test_persistent_fence_silent_when_contract_followed():
    def prog(c, m):
        h = c.allreduce_init(m.arr(np.ones(16)))
        r0 = h.start().wait()
        r1 = h.start().wait()
        del r0, r1  # contract honoured: release early
        got = None
        for _ in range(6):  # rebinding loop: the old result dies
            got = h.start().wait()
        return float(got[0])

    ref, got = both(prog, progress="thread")
    assert ref.results == got.results == [2.0, 2.0]


def test_persistent_signature_checked_once_at_init():
    """The signature is exchanged at init and frozen: a divergent
    persistent init raises, and rounds add no signature traffic."""
    def bad(c, m):
        c.allreduce_init(m.arr(np.ones(4 if c.rank == 0 else 2)))

    ref, got = both(bad, progress="thread")
    assert_same_diagnosis(ref, got)

    def rounds(c, m):
        h = c.allreduce_init(m.arr(np.ones(4)))
        for _ in range(3):
            h.start().wait()

    sent = {}
    for m in PKGS:
        for flag in (False, True):
            base = m.mpit.pvar_read("msgs_sent")
            m.run(rounds, 2, progress="thread", verify=flag)
            sent[m.port, flag] = m.mpit.pvar_read("msgs_sent") - base
    # verify on adds the init's signature exchange alone: one message a
    # rank on two ranks, however many rounds run
    assert sent[True, True] - sent[True, False] == 2
    assert sent[False, True] - sent[False, False] == 2


# -- process worlds: FileBoard -----------------------------------------------


def _blocked(r, t):
    return {"state": "blocked", "rank": r, "targets": [t], "mode": "AND"}


def test_fileboard_summary_compaction(tmp_path):
    """Both packages' boards, driven in lockstep: the compacted summary
    spares the unchanged files' parses, identically."""
    size = 10
    sides = []
    for m in PKGS:
        rdv = str(tmp_path / f"p{m.port}")
        os.makedirs(rdv)
        boards = [m.FileBoard(rdv, r, size) for r in range(size)]
        for r in range(size):
            boards[r].publish(r, _blocked(r, (r + 1) % size))
        sides.append((m, rdv, boards, m.FileBoard(rdv, 0, size)))

    def step(fn):
        outs = [fn(*s) for s in sides]
        assert outs[1] == outs[0]
        return outs[1]

    def view(out):
        return {r: (e["rank"], e["targets"]) for r, e in out.items()}

    out = step(lambda m, rdv, b, rd: (view(rd.read_all()), rd.fallback_reads))
    assert out[1] == size
    time.sleep(FileBoard._MTIME_TRUST_S + 0.1)
    step(lambda m, rdv, b, rd: view(rd.read_all()))
    base = step(lambda m, rdv, b, rd: rd.fallback_reads)
    out2 = step(lambda m, rdv, b, rd: (view(rd.read_all()), rd.fallback_reads))
    assert out2[1] == base

    def republish(m, rdv, b, rd):
        b[3].publish(3, _blocked(3, 7))
        return view(rd.read_all())[3], rd.fallback_reads
    assert step(republish) == ((3, [7]), base + 1)

    def retract(m, rdv, b, rd):
        b[5].publish(5, None)
        return sorted(rd.read_all())
    assert 5 not in step(retract)

    def fresh(m, rdv, b, rd):
        r2 = m.FileBoard(rdv, 1, size)
        return sorted(r2.read_all()), r2.fallback_reads <= 1
    assert step(fresh)[1]


def test_fileboard_summary_lock_serializes_compaction(tmp_path):
    size = 8
    rdv = str(tmp_path)
    pub = [FileBoard(rdv, r, size) for r in range(size)]
    for r in range(size):
        pub[r].publish(r, _blocked(r, (r + 1) % size))
    time.sleep(FileBoard._MTIME_TRUST_S + 0.1)
    a = FileBoard(rdv, 0, size)
    out_a = a.read_all()
    assert set(out_a) == set(range(size)) and a.summary_writes == 1
    lock_path = os.path.join(rdv, FileBoard.LOCK)
    assert not os.path.exists(lock_path)
    fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    os.close(fd)
    summary_path = os.path.join(rdv, FileBoard.SUMMARY)
    mtime_before = os.stat(summary_path).st_mtime_ns
    b = FileBoard(rdv, 1, size)
    b._cache_loaded = True  # a reader whose cache is cold
    b._cache = {}
    out_b = b.read_all()
    assert {r: e["rank"] for r, e in out_b.items()} == \
        {r: e["rank"] for r, e in out_a.items()}
    assert b.fallback_reads == 0 and b.summary_writes == 0
    assert os.stat(summary_path).st_mtime_ns == mtime_before
    pub[4].publish(4, _blocked(4, 0))
    time.sleep(FileBoard._MTIME_TRUST_S + 0.1)
    assert b.read_all()[4]["targets"] == [0]
    assert b.fallback_reads == 1 and b.summary_writes == 0
    os.unlink(lock_path)
    b.read_all()
    assert b.summary_writes == 1
    fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    os.close(fd)
    old = time.time() - FileBoard._LOCK_STALE_S - 1.0
    os.utime(lock_path, (old, old))
    pub[6].publish(6, _blocked(6, 2))
    time.sleep(FileBoard._MTIME_TRUST_S + 0.1)
    assert b.read_all()[6]["targets"] == [2]
    assert b.lock_takeovers == 1 and b.summary_writes == 2
    assert not os.path.exists(lock_path)


def test_fileboard_two_concurrent_readers(tmp_path):
    import threading

    size = 6
    rdv = str(tmp_path)
    pub = [FileBoard(rdv, r, size) for r in range(size)]
    for r in range(size):
        pub[r].publish(r, _blocked(r, (r + 1) % size))
    stop = time.monotonic() + 1.5
    errs = []

    def reader_loop(rank):
        board = FileBoard(rdv, rank, size)
        while time.monotonic() < stop:
            for r, e in board.read_all().items():
                if e["rank"] != r:
                    errs.append(f"torn entry: {r} -> {e}")

    def publisher_loop():
        i = 0
        while time.monotonic() < stop:
            i += 1
            pub[i % size].publish(i % size, _blocked(i % size, (i + 1) % size))
            time.sleep(0.01)

    threads = [threading.Thread(target=reader_loop, args=(0,)),
               threading.Thread(target=reader_loop, args=(1,)),
               threading.Thread(target=publisher_loop)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not errs, errs[:5]
    assert not os.path.exists(os.path.join(rdv, FileBoard.LOCK))


def test_fileboard_scandir_single_pass(tmp_path):
    size = 10
    blocked = [1, 4, 7, 9]
    outs = []
    for m in PKGS:
        rdv = tmp_path / f"p{m.port}"
        rdv.mkdir()
        boards = [m.FileBoard(str(rdv), r, size) for r in range(size)]
        for r in blocked:
            boards[r].publish(r, _blocked(r, (r + 1) % size))
        (rdv / "pending.summary.json.tmp.999.0").write_text("junk")
        (rdv / "pending.3.tmp").write_text("torn")
        (rdv / f"pending.{size + 5}").write_text("{}")  # out of range
        (rdv / "port.0").write_text("0")
        reader = m.FileBoard(str(rdv), 0, size)
        out = reader.read_all()
        outs.append((sorted(out), reader.fallback_reads))
    assert outs[1] == outs[0] == (blocked, len(blocked))


# -- process worlds: the launcher's --verify ---------------------------------


_E2E_DEADLOCK = """
import sys
import mpi_tpu_torch
from mpi_tpu_torch import mpit
from mpi_tpu_torch.errors import DeadlockError

mpit.cvar_write("verify_stall_timeout_s", 1.0)
comm = mpi_tpu_torch.init()   # MPI_TPU_VERIFY=1: pending-op files
try:
    comm.recv(source=1 - comm.rank, tag=4)
    sys.exit(7)  # impossibly completed
except DeadlockError as e:
    msg = str(e)
    assert "rank 0" in msg and "rank 1" in msg, msg
    assert "tag=4" in msg, msg
    print(f"rank {comm.rank} diagnosed", flush=True)
    sys.exit(0)
"""

_E2E_RACE = """
import sys, time
import torch
import mpi_tpu_torch
from mpi_tpu_torch import mpit, verify

comm = mpi_tpu_torch.init()   # MPI_TPU_VERIFY=1: clocks ride the frames
if comm.rank == 0:
    while not (comm.iprobe(source=1, tag=7)
               and comm.iprobe(source=2, tag=7)):
        time.sleep(0.001)
    a = comm.recv(source=-1, tag=7)
    b = comm.recv(source=-1, tag=7)
    assert sorted([float(a[0]), float(b[0])]) == [1.0, 2.0], (a, b)
    assert mpit.pvar_read("verify_wildcard_races") >= 1
    race = [ln for ln in verify.take_report() if "wildcard race" in ln]
    assert race, "no race line in the report"
    assert "from rank 1" in race[0] and "rank 2" in race[0], race[0]
    print("race observed", flush=True)
else:
    comm.send(torch.full((2,), float(comm.rank)), 0, tag=7)
assert mpit.pvar_read("bytes_pickled_sent") == 0
comm.barrier()
mpi_tpu_torch.finalize()
"""


_E2E_CLEAN_SHM = """
import torch
import mpi_tpu_torch
from mpi_tpu_torch import mpit, verify

comm = mpi_tpu_torch.init()   # MPI_TPU_VERIFY=1 over the shm transport
out = comm.allreduce(torch.ones(256))                 # the sm arena path
assert float(out[0]) == comm.size
comm.barrier(algorithm="sm")
items = comm.allgather(torch.full((4,), comm.rank))
assert float(items[1][0]) == 1.0
comm.allreduce(torch.ones(1 << 20), algorithm="compressed:bf16")
assert mpit.pvar_read("coll_sm_hits") >= 1, "arena did not serve"
problems = verify.finalize_report()
assert problems == [], problems
for p in mpit.pvar_list():
    if p.startswith("verify_") and p != "verify_clock_bytes":
        assert mpit.pvar_read(p) == 0, (p, mpit.pvar_read(p))
mpi_tpu_torch.finalize()
print("clean shm verify OK", flush=True)
"""


def _launch(tmp_path, body, n, backend="socket"):
    prog = tmp_path / "prog.py"
    prog.write_text(body)
    return subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", str(n),
         "--device", "cpu", "--verify", "--backend", backend, "--timeout",
         "120", str(prog)],
        capture_output=True, text=True, cwd=REPO, timeout=180)


@pytest.mark.parametrize("body,n,marker,backend", [
    (_E2E_DEADLOCK, 2, "diagnosed", "socket"),
    (_E2E_RACE, 3, "race observed", "socket"),
    (_E2E_RACE, 3, "race observed", "shm"),
    (_E2E_CLEAN_SHM, 2, "clean shm verify OK", "shm")],
    ids=["socket_deadlock", "socket_wildcard_race", "shm_wildcard_race",
         "shm_arena_clean"])
def test_e2e_process_world_under_launcher_verify(tmp_path, body, n, marker,
                                                 backend):
    proc = _launch(tmp_path, body, n, backend)
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert marker in proc.stdout


def test_host_verify_example_on_cpu_ranks(tmp_path):
    """``examples/host_verify.py`` (the card's phase 20) on 3 CPU ranks:
    the clean ring pickles no payload byte, the race is named, rank 0's
    3.5 s of products are no deadlock, the receive cycle is one."""
    import json

    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", "3",
         "--device", "cpu", "--verify", "--timeout", "120",
         os.path.join(REPO, "mpi_tpu_torch", "examples", "host_verify.py"),
         "--out", str(out), "--mib", "1", "--small-mib", "1"],
        capture_output=True, text=True, cwd=REPO, timeout=180)
    assert proc.returncode == 0, proc.stderr[-1500:]
    recs = [json.load(open(out / f"rank{r}.json")) for r in range(3)]
    assert "from rank 1" in recs[0]["wildcard_race"]["line"]
    assert recs[0]["products_s"] > 3.0
    for rec in recs:
        assert rec["deadlock"]["ranks"] == [0, 1, 2]
        assert "host_verify.py" in rec["deadlock"]["message"]
        assert rec["pvars"]["verify_deadlocks_detected"] == 1


def test_stamped_frame_before_the_receiver_enables_verify(tmp_path, monkeypatch):
    """A verified process world's transports carry their vector clock from
    construction: a stamped frame from a peer that enabled the verifier
    first is unwrapped and matched, not queued under its wire envelope
    (where no receive could ever match it)."""
    from mpi_tpu_torch import membership
    from mpi_tpu_torch.verify.vclock import VClock

    monkeypatch.setenv("MPI_TPU_VERIFY", "1")
    ts = [membership.make_transport("socket", r, 2, str(tmp_path), device="cpu")
          for r in range(2)]
    try:
        assert all(isinstance(t.verify_clock, VClock) for t in ts)
        assert ts[0].mailbox.clock is ts[0].verify_clock
        ts[1].send(0, 0, 5, torch.arange(3.0))
        payload, src, tag = ts[0].recv(1, 0, 5, timeout=30)
        assert (src, tag) == (1, 5) and torch.equal(payload, torch.arange(3.0))
        assert ts[0].verify_clock._vec == [1, 1]  # merged the stamp
    finally:
        for t in ts:
            t.close()


# -- compressed collectives: the resolved wire name in the signature -----------


def test_compressed_wire_dtype_divergence():
    """A group mixing bf16 and int8 compressed entries raises
    CollectiveMismatchError naming both RESOLVED signatures, before any
    data moves."""
    def prog(c, m):
        algo = "compressed:bf16" if c.rank == 0 else "compressed:int8"
        c.allreduce(m.arr(np.ones(64, np.float32)), algorithm=algo)  # mpilint: ok

    ref, got = both(prog)
    cause = assert_same_diagnosis(ref, got)
    assert "compressed:bf16" in str(cause) and "compressed:int8" in str(cause)
    assert got.pvars["verify_collective_mismatches"] >= 1


def test_compressed_vs_uncompressed_divergence():
    def prog(c, m):
        algo = "compressed" if c.rank == 0 else "ring"
        c.allreduce(m.arr(np.ones(64, np.float32)), algorithm=algo)  # mpilint: ok

    ref, got = both(prog)
    cause = assert_same_diagnosis(ref, got)
    assert "compressed:bf16" in str(cause) and "ring" in str(cause)


def test_compressed_topk_k_rides_signature_counts(monkeypatch):
    """The resolved k rides the signature's counts in both packages; a
    skew injected at the signature boundary is diagnosed alike."""
    from mpi_tpu import compress as ref_compress
    from mpi_tpu.verify import collcheck as ref_collcheck
    from mpi_tpu_torch import compress
    from mpi_tpu_torch.verify import collcheck

    n = 64
    k = compress.topk_k(n)
    assert k == ref_compress.topk_k(n)
    for mod in (ref_collcheck, collcheck):
        seen = []
        real = mod.check

        def spy(comm, coll, _real=real, _seen=seen, **kw):
            _seen.append((comm.rank, kw.get("counts")))
            return _real(comm, coll, **kw)

        monkeypatch.setattr(mod, "check", spy)
    both(lambda c, m: c.allreduce(m.arr(np.ones(n, np.float32)),
                                  algorithm="compressed:topk"))
    reals = {}
    for mod in (ref_collcheck, collcheck):
        monkeypatch.undo()
    for mod in (ref_collcheck, collcheck):
        real = mod.check
        reals[mod] = real

        def skewed(comm, coll, _real=real, **kw):
            if comm.rank == 1 and kw.get("counts") is not None:
                kw["counts"] = (kw["counts"][0] + 1,)
            return _real(comm, coll, **kw)

        monkeypatch.setattr(mod, "check", skewed)
    ref, got = both(lambda c, m: c.allreduce(m.arr(np.ones(n, np.float32)),
                                             algorithm="compressed:topk"))
    cause = assert_same_diagnosis(ref, got)
    assert f"counts=[{k}]" in str(cause) and f"counts=[{k + 1}]" in str(cause)
