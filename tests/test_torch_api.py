"""The port's flat MPI layer (``mpi_tpu_torch/api.py``) against the
reference's (``mpi_tpu/api.py``).

Held unchanged on the port (``tests/test_torch_host_ref.py``: the
reference's inputs, oracles and assertions on ``run_local(...,
device="cpu")``): the typed host paths ``tests/test_datatypes.py:172``,
``:244``, ``:314``; the ``MPI_*`` cases of ``tests/test_progress.py``
(``:250``, ``:281``, ``:303``, ``:427``: ``MPI_Waitany``'s poll scope and
the verifier) and of ``tests/test_fault_tolerance.py`` (``:197``,
``:356``: ``MPIX_*`` and ``ERRORS_RETURN`` with a dead member).  The
``MPI_*`` cases of ``tests/test_errors.py``, ``tests/test_nonblocking.py``,
``tests/test_attributes.py:72`` and ``tests/test_groups.py:111`` run in
their ``tests/test_torch_host_ref_*.py`` files.  ``MPI_Abort`` under the
launcher (``tests/test_failure_story.py:68``) runs with the port's
launcher on socket and shm.  The cases below hold a flat program and
the typed tensor path through both packages, bitwise, and that the
MPI-IO and dynamic-process wrappers reach the port's ``io`` and
``spawn``.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import mpi_tpu
import mpi_tpu_torch
from mpi_tpu import api as ref_api
from mpi_tpu import datatypes as ref_dt
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import api
from mpi_tpu_torch import datatypes as dt
from tests.test_torch_host_local import assert_same
from tests.test_torch_host_ref import port_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

globals().update(port_cases("test_datatypes", only=(
    "test_recv_buf_without_datatype_rejected",
    "test_typed_send_recv_column_local_backend",
    "test_errhandler_covers_typed_paths")))
globals().update(port_cases("test_progress", only=(
    "test_waitany_drain_loop_deadlock_detected",
    "test_slow_peer_never_false_positives",
    "test_waitany_publishes_exact_request_set",
    "test_mode_resolution_and_cvar")))
globals().update(port_cases("test_fault_tolerance", only=(
    "test_agree_raises_until_failures_acked",
    "test_errors_return_with_dead_member")))


def test_api_names_are_the_references():
    assert sorted(api.__all__) == sorted(ref_api.__all__)
    for name in api.__all__:
        assert hasattr(api, name), name


def test_api_imports_without_io_or_spawn():
    """Since ROADMAP 16.6b landed, ``api`` binds ``io`` as the reference's
    does (``mpi_tpu/api.py:1024``) and imports ``spawn`` at each call; its
    access modes and seek origins are ``io``'s own, with the reference's
    values."""
    code = ("import sys, mpi_tpu_torch.api as a, mpi_tpu_torch.io as io\n"
            "assert a.MPI_MODE_RDWR == io.MODE_RDWR\n"
            "assert a.MPI_SEEK_END == io.SEEK_END\n"
            "assert a.MPI_File_delete is io.file_delete\n"
            "print(a.MPI_MODE_RDWR, a.MPI_SEEK_END)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr[-800:]
    assert out.stdout.split() == [str(ref_api.MPI_MODE_RDWR),
                                  str(ref_api.MPI_SEEK_END)]


class _Handle:
    """A file handle that records the method a wrapper calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a, **k: self.calls.append((name, a)) or name


# wrapper -> (module, function it reaches, arguments)
_WIRED = {
    "MPI_Comm_spawn": ("spawn", "comm_spawn", (["w.py"], 2)),
    "MPI_Comm_spawn_multiple": ("spawn", "comm_spawn_multiple",
                                ([(["w.py"], 1)],)),
    "MPI_Comm_get_parent": ("spawn", "comm_get_parent", ()),
    "MPI_Open_port": ("spawn", "open_port", ()),
    "MPI_Close_port": ("spawn", "close_port", ("p",)),
    "MPI_Comm_accept": ("spawn", "comm_accept", ("p",)),
    "MPI_Comm_connect": ("spawn", "comm_connect", ("p",)),
    "MPI_Publish_name": ("spawn", "publish_name", ("svc", "p")),
    "MPI_Unpublish_name": ("spawn", "unpublish_name", ("svc",)),
    "MPI_Lookup_name": ("spawn", "lookup_name", ("svc",)),
    "MPI_File_open": ("io", "file_open", ("f.bin",)),
    "MPI_Register_datarep": ("io", "register_datarep",
                             ("rep", None, None)),
}


@pytest.mark.parametrize("name", [
    "MPI_Comm_spawn", "MPI_Comm_spawn_multiple", "MPI_Comm_get_parent",
    "MPI_Open_port", "MPI_Close_port", "MPI_Comm_accept", "MPI_Comm_connect",
    "MPI_Publish_name", "MPI_Unpublish_name", "MPI_Lookup_name",
    "MPI_File_open", "MPI_File_delete", "MPI_File_read_at",
    "MPI_File_write_ordered", "MPI_Register_datarep"])
def test_unported_wrappers_name_their_roadmap_item(name, monkeypatch,
                                                   tmp_path):
    """These wrappers raised naming ROADMAP 16.6b until it landed; now each
    reaches the port's ``spawn`` / ``io`` function (or the file handle's
    method) the reference's wrapper reaches (``mpi_tpu/api.py:951-1140``)."""
    from mpi_tpu_torch import io as mio
    from mpi_tpu_torch import spawn

    if name == "MPI_File_delete":
        path = tmp_path / "gone.bin"
        path.write_bytes(b"x")
        api.MPI_File_delete(str(path))
        assert not path.exists()
        return
    if name in ("MPI_File_read_at", "MPI_File_write_ordered"):
        fh = _Handle()
        args = (fh, 0, 4) if name == "MPI_File_read_at" else (fh, [1, 2])
        getattr(api, name)(*args)
        want = "read_at" if name == "MPI_File_read_at" else "write_ordered"
        assert fh.calls == [(want, args[1:])]
        return
    module, fn, args = _WIRED[name]
    calls = []
    monkeypatch.setattr({"spawn": spawn, "io": mio}[module], fn,
                        lambda *a, **k: calls.append(a) or "reached")
    comm = mpi_tpu_torch.comm_self(device="cpu")
    kwargs = {"comm": comm} if name in ("MPI_Comm_spawn",
                                        "MPI_Comm_spawn_multiple",
                                        "MPI_Comm_accept",
                                        "MPI_Comm_connect",
                                        "MPI_File_open") else {}
    assert getattr(api, name)(*args, **kwargs) in ("reached", None)
    # MPI_File_open passes the world communicator first (io.file_open)
    got = calls[0][1:] if name == "MPI_File_open" else calls[0]
    assert len(calls) == 1 and got[:len(args)] == args


def _flat_prog(c, m, arr):
    """One flat-API program: collectives, nonblocking requests drained by
    MPI_Waitany / Waitsome / Testall, persistent and partitioned rounds,
    an intercommunicator, sessions and error codes."""
    A = m.api
    r, n = A.MPI_Comm_rank(c), A.MPI_Comm_size(c)
    x = arr(np.random.default_rng(r).standard_normal(9).astype(np.float32))
    out = [A.MPI_Allreduce(x, comm=c), A.MPI_Allreduce(x, A.MAX, comm=c),
           A.MPI_Bcast(x if r == 1 else None, root=1, comm=c),
           A.MPI_Reduce(x, root=2, comm=c), A.MPI_Allgather(x, comm=c),
           A.MPI_Scan(x, comm=c), A.MPI_Exscan(x, comm=c),
           A.MPI_Reduce_scatter(arr(np.stack([np.asarray(x)] * n)), comm=c),
           A.MPI_Alltoall([x * (k + 1) for k in range(n)], comm=c)]
    reqs = [A.MPI_Irecv(source=s, tag=5, comm=c) for s in range(n) if s != r]
    for d in range(n):
        if d != r:
            A.MPI_Send(x + d, dest=d, tag=5, comm=c)
    got = {}
    for _ in reqs:
        i, v = A.MPI_Waitany(reqs)
        got[i] = v
    out.append([got[i] for i in sorted(got)])
    assert A.MPI_Waitany(reqs) == (None, None)
    h = A.MPI_Allreduce_init(x, comm=c)
    out.append([h.start().wait() for _ in range(3)])
    ir = A.MPI_Iallreduce(x, comm=c)
    out.append(A.MPI_Testall([ir])[1] if A.MPI_Testall([ir])[0] else [ir.wait()])
    ic = A.MPI_Intercomm_create(list(range(n // 2)), list(range(n // 2, n)), comm=c)
    out.append((A.MPI_Comm_remote_size(ic), A.MPI_Comm_test_inter(ic),
                ic.allreduce(x)))
    s = m.mpi4.session_init(base_comm=c)
    g = A.MPI_Group_from_session_pset(s, "mpi://WORLD")
    sc = A.MPI_Comm_create_from_group(g, "flat", session=s)
    out.append(A.MPI_Allreduce(x, comm=sc))
    A.MPI_Session_finalize(s)
    A.MPI_Comm_set_errhandler(A.MPI_ERRORS_RETURN, comm=c)
    out.append(int(A.MPI_Bcast(x, root=n + 3, comm=c)))
    A.MPI_Barrier(comm=c)
    return out


def test_flat_program_matches_reference_bitwise():
    import mpi_tpu.api  # noqa: F401
    import mpi_tpu.mpi4  # noqa: F401

    n = 4
    ref = ref_run_local(lambda c: _flat_prog(c, mpi_tpu, np.asarray), n)
    got = mpi_tpu_torch.run(
        lambda c: _flat_prog(c, mpi_tpu_torch,
                             lambda a: torch.from_numpy(np.asarray(a))),
        backend="local", nranks=n, device="cpu")
    for r in range(n):
        assert_same(ref[r], got[r], f"rank {r}")


@pytest.mark.parametrize("count", [1, 3])
def test_typed_send_recv_tensor_matches_the_numpy_path(count):
    """A strided column (MPI_Type_vector) sent from a tensor and received
    into a tensor, against the reference's numpy path: the same bytes."""
    a = np.arange(4 * 5 * count, dtype=np.float64).reshape(4 * count, 5)

    def prog(c, m, mod, arr, zeros):
        col = mod.type_vector(4, 1, 5, np.float64).commit()
        if c.rank == 0:
            m.api.MPI_Send(arr(a), dest=1, comm=c, count=count,
                           datatype=mod.Datatype(col.base_dtype,
                                                 col.indices + 2, col.extent))
            return None
        out = zeros((4 * count, 5))
        back = m.api.MPI_Recv(source=0, comm=c, datatype=col, buf=out,
                              count=count)
        assert back is out
        return out

    ref = ref_run_local(lambda c: prog(c, mpi_tpu, ref_dt, np.asarray,
                                       np.zeros), 2)
    got = mpi_tpu_torch.run(
        lambda c: prog(c, mpi_tpu_torch, dt, torch.from_numpy,
                       lambda s: torch.zeros(s, dtype=torch.float64)),
        backend="local", nranks=2, device="cpu")
    assert_same(ref[1], got[1])
    assert isinstance(got[1], torch.Tensor)


def test_get_count_and_elements_take_torch_dtypes():
    st = mpi_tpu_torch.Status()
    st.count_bytes = 24
    assert api.MPI_Get_count(st, torch.float64) == 3
    assert api.MPI_Get_count(st, np.float32) == 6
    assert api.MPI_Get_elements(st, torch.int32) == 6


ABORT_PROG = textwrap.dedent("""
    import os
    import mpi_tpu_torch
    from mpi_tpu_torch import api

    comm = mpi_tpu_torch.init()
    if comm.rank == 1:
        api.MPI_Abort(13)
    # every other rank would block forever; the launcher must kill them
    marker = os.environ["MARKER_DIR"] + f"/survived.{comm.rank}"
    comm.recv(source=1, tag=9)  # never sent
    open(marker, "w").write("should not get here")
""")


@pytest.mark.parametrize("backend", ["socket", "shm"])
def test_mpi_abort_kills_all_and_propagates(tmp_path, backend):
    """``tests/test_failure_story.py:68`` with the port's launcher: exit
    code 13 propagates, ranks 0 and 2 are killed well inside the timeout,
    and no survivor marker is written."""
    script = tmp_path / "abort.py"
    script.write_text(ABORT_PROG)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", "3",
         "--backend", backend, "--device", "cpu", str(script)],
        capture_output=True, text=True, cwd=ROOT, timeout=180,
        env=dict(os.environ, MARKER_DIR=str(tmp_path), OMP_NUM_THREADS="1"))
    assert proc.returncode == 13, proc.stderr[-800:]
    assert "MPI_Abort(code=13)" in proc.stderr
    assert not [f for f in os.listdir(tmp_path) if f.startswith("survived.")]
    assert time.monotonic() - t0 < 120.0
