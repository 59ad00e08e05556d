"""The port's flat-layer examples (``mpi_tpu_torch/examples/
master_worker.py``, ``session_library.py``, ``datatypes_demo.py``)
against the reference's oracles, as ``tests/test_examples_parity.py:81-103``
holds the reference's.

``master_worker`` computes each task on the worker's device as a float64
sum of the reference's terms, where the reference's ``_task`` adds them in
a Python loop: the two agree to float64 rounding (atol 1e-12, rtol 0;
each task sums at most 350 terms of magnitude at most 1).  The others are
exact.  ``session_library`` on rank threads and under the launcher is
``tests/test_torch_mpi4.py::test_session_library_local_and_launcher``.
"""

import os
import subprocess
import sys

import numpy as np
import torch

import mpi_tpu_torch
from examples.master_worker import _task as ref_task
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch.examples import datatypes_demo, master_worker, session_library

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(fn, n):
    return mpi_tpu_torch.run(fn, backend="local", nranks=n, device="cpu")


def _check(got, n_tasks):
    assert len(got) == n_tasks and all(isinstance(r, torch.Tensor) for r in got)
    assert all(r.dtype == torch.float64 and r.device.type == "cpu" for r in got)
    np.testing.assert_allclose([float(r) for r in got],
                               [ref_task(i) for i in range(n_tasks)],
                               rtol=0, atol=1e-12)


def test_master_worker_matches_serial_oracle():
    """Every task's result exactly once (25 tasks, 3 workers); workers
    return None."""
    res = _run(lambda c: master_worker.run(c, 25), 4)
    _check(res[0], 25)
    assert res[1] is None and res[3] is None
    # the port's own serial computation is the same value, bitwise
    assert all(torch.equal(a, master_worker._task(i))
               for i, a in enumerate(res[0]))


def test_master_worker_single_rank_degenerates():
    _check(_run(lambda c: master_worker.run(c, 7), 1)[0], 7)


def test_master_worker_more_workers_than_tasks():
    """Surplus workers are stopped at priming and get no dangling irecv."""
    _check(_run(lambda c: master_worker.run(c, 2), 6)[0], 2)


def test_session_library_matches_the_reference():
    from examples.session_library import session_program as ref_program

    assert _run(session_library.session_program, 4) == \
        ref_run_local(ref_program, 4)


def test_datatypes_demo_column_exchange():
    res = _run(datatypes_demo.demo, 2)
    a = np.arange(20.0).reshape(4, 5)
    want = np.zeros((4, 5))
    want[:, 0] = a[:, 2]
    assert res[1].dtype == torch.float64
    np.testing.assert_array_equal(res[1].numpy(), want)
    np.testing.assert_array_equal(res[0].numpy(), a)


def test_flat_examples_under_the_launcher(tmp_path):
    """datatypes_demo and master_worker as 2 and 3 CPU rank processes."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for n, mod, want in (
            (2, "datatypes_demo.py", "rank 1 unpacked into column 0"),
            (3, "master_worker.py", "master_worker: 40/40 tasks done")):
        proc = subprocess.run(
            [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", str(n),
             "--device", "cpu", os.path.join(ROOT, "mpi_tpu_torch", "examples", mod)],
            capture_output=True, text=True, cwd=ROOT, timeout=240, env=env)
        assert proc.returncode == 0, proc.stderr[-800:]
        assert want in proc.stdout, proc.stdout[-800:]
    total = sum(ref_task(i) for i in range(40))
    assert f"sum={total:.4f}" in proc.stdout
