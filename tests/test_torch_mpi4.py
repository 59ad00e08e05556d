"""The port's MPI-4 previews (``mpi_tpu_torch/mpi4.py``) against the
reference's.

The 25 cases of ``tests/test_mpi4.py`` run unchanged on the port
(``tests/test_torch_host_ref.py``: the reference's inputs, oracles and
assertions, on ``run_local(..., device="cpu")``), except three whose
other half is the reference's SPMD backend or launcher, each held below
in the port's spelling:

* ``:62`` ``test_persistent_rejected_on_spmd``: the port's rank-vmap
  program, ``test_persistent_rejected_on_spmd_torch``;
* ``:384`` ``test_session_library_example_local_and_launcher``: the
  port's ``mpi_tpu_torch/examples/session_library.py`` on rank threads
  and under the port's launcher, ``test_session_library_local_and_launcher``;
* ``:477`` ``test_isendrecv_flat_api_and_spmd_diagnostic``: the flat
  half on the port's ``api`` and the diagnostic of ``TorchCommunicator``,
  ``test_isendrecv_flat_api_and_spmd_diagnostic_torch``.

``tests/test_nbc_engine.py:301`` (the generic persistent collectives'
routing) runs unchanged too.  The seeded cases below hold partitioned
sends and persistent rounds through both packages, bitwise.  The card
case (a refill right after ``pready``, from a side stream) is
``tests/test_torch_gpu_real.py::test_pready_snapshot_survives_a_refill_on_the_card``.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mpi_tpu
import mpi_tpu.api  # noqa: F401  (``m.api`` in the two-package programs)
import mpi_tpu_torch
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import api, mpi4
from mpi_tpu_torch.transport.local import run_local as port_run_local
from tests.test_torch_host_local import assert_same
from tests.test_torch_host_ref import port_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

globals().update(port_cases("test_mpi4", {
    "test_persistent_rejected_on_spmd": (
        "runs the reference's TPU backend; the port's rank-vmap program is "
        "test_persistent_rejected_on_spmd_torch"),
    "test_session_library_example_local_and_launcher": (
        "runs the reference's example under the reference's launcher; the "
        "port's example and launcher are test_session_library_local_and_launcher"),
    "test_isendrecv_flat_api_and_spmd_diagnostic": (
        "its diagnostic half runs the reference's SPMD backend; the port's is "
        "test_isendrecv_flat_api_and_spmd_diagnostic_torch"),
}))
globals().update(port_cases("test_nbc_engine", only=(
    "test_mpi4_persistent_collective_routes_plannable_kinds",)))


@pytest.fixture(autouse=True)
def _no_world_left_behind():
    """A session made without ``base_comm`` builds the process's world (a
    one-rank self world, as in the reference); finalize it after the test
    so no later test in this process inherits it."""
    had = mpi_tpu_torch.is_initialized()
    yield
    if not had and mpi_tpu_torch.is_initialized():
        mpi_tpu_torch.finalize()


def both(prog, n, **kw):
    ref = ref_run_local(lambda c: prog(c, mpi_tpu, np.asarray), n, **kw)
    got = port_run_local(
        lambda c: prog(c, mpi_tpu_torch, lambda a: torch.from_numpy(np.asarray(a))),
        n, device="cpu", **kw)
    for r in range(n):
        assert_same(ref[r], got[r], f"rank {r}")
    return got


@pytest.mark.parametrize("copy", [True, False])
def test_partitioned_send_from_producer_threads_matches_reference(copy):
    """8 partitions of a seeded float32 buffer, readied by 4 producer
    threads in shuffled order and refilled right after each pready; the
    receiver assembles them bitwise equal to the snapshot in both
    packages (copy=False is the aliasing transport)."""
    parts, width = 8, 33

    def prog(c, m, arr):
        rng = np.random.default_rng(7)
        data = rng.standard_normal((parts, width)).astype(np.float32)
        if c.rank == 0:
            buf = arr(data.copy())
            req = m.mpi4.psend_init(c, buf, parts, dest=1, tag=4).start()
            order = list(rng.permutation(parts))

            def producer(ids):
                for i in ids:
                    req.pready(int(i))
                    buf[int(i)] = buf[int(i)] * 0 - 1  # refill after ready

            ts = [threading.Thread(target=producer, args=(order[k::4],))
                  for k in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            req.wait()
            return None
        req = m.mpi4.precv_init(c, parts, source=0, tag=4).start()
        return req.wait()

    got = both(prog, 2, copy_payloads=copy)
    want = np.random.default_rng(7).standard_normal((parts, width)).astype(np.float32)
    np.testing.assert_array_equal(np.stack([p.numpy() for p in got[1]]), want)


def test_persistent_allreduce_init_rounds_match_reference():
    """10 rounds of ``MPI_Allreduce_init`` over a buffer refilled in place
    between rounds; bitwise equal to the reference round by round."""
    def prog(c, m, arr):
        buf = arr(np.zeros(6, np.float32))
        h = m.api.MPI_Allreduce_init(buf, comm=c)
        out = []
        for k in range(10):
            buf[:] = arr(np.random.default_rng(10 * k + c.rank)
                         .standard_normal(6).astype(np.float32))
            out.append(h.start().wait())
        return out

    both(prog, 4)


def test_persistent_rejected_on_spmd_torch():
    def prog(comm):
        with pytest.raises(NotImplementedError, match="already a plan"):
            mpi4.persistent_collective(comm, "allreduce", comm.rank.float())
        return comm.allreduce(comm.rank.float())

    mpi_tpu_torch.run(prog, nranks=4, device="cpu")


def test_isendrecv_flat_api_and_spmd_diagnostic_torch():
    from mpi_tpu_torch.gpu import SpmdSemanticsError

    def prog(comm):
        req = api.MPI_Isendrecv(comm.rank, (comm.rank + 1) % comm.size,
                                (comm.rank - 1) % comm.size, comm=comm)
        return req.wait()

    assert mpi_tpu_torch.run(prog, backend="local", nranks=3,
                             device="cpu") == [2, 0, 1]

    def sprog(comm):
        with pytest.raises(SpmdSemanticsError, match="Isendrecv"):
            comm.isendrecv(1.0, 0)  # mpilint: ok (raises: the SPMD diagnostic)
        with pytest.raises(SpmdSemanticsError, match="Isendrecv_replace"):
            comm.isendrecv_replace(torch.zeros(2), 0)  # mpilint: ok (raises)
        return comm.allreduce(comm.rank.float())

    mpi_tpu_torch.run(sprog, nranks=8, device="cpu")


def test_session_library_local_and_launcher(tmp_path):
    """The port's session_library example: identical results on rank
    threads and over the port's launcher (3 CPU rank processes)."""
    from mpi_tpu_torch.examples.session_library import session_program

    n = 3
    want = (sum(range(1, n + 1)) / n, float(sum(range(n))), "app")
    assert mpi_tpu_torch.run(session_program, backend="local", nranks=n,
                             device="cpu") == [want] * n
    assert ref_run_local(
        __import__("examples.session_library", fromlist=["x"]).session_program,
        n) == [want] * n
    out = tmp_path / "out"
    prog = tmp_path / "prog.py"
    prog.write_text(
        "import json\n"
        "import mpi_tpu_torch\n"
        "from mpi_tpu_torch.examples.session_library import session_program\n"
        "comm = mpi_tpu_torch.init()\n"
        "res = session_program(comm)\n"
        f"open({str(out)!r} + str(comm.rank), 'w').write(json.dumps(res))\n"
        "mpi_tpu_torch.finalize()\n")
    r = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", str(n),
         "--device", "cpu", str(prog)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-800:]
    for rank in range(n):
        assert tuple(json.loads(open(str(out) + str(rank)).read())) == want
