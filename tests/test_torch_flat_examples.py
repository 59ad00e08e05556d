"""The port's flat-layer examples (``mpi_tpu_torch/examples/
master_worker.py``, ``session_library.py``, ``datatypes_demo.py``, and the
process examples ``parallel_io.py``, ``spawn_workers.py``,
``coupled_models.py``) against the reference's oracles, as
``tests/test_examples_parity.py:81-103`` holds the reference's.  The
process examples run on the CPU beside the reference's own examples under
the reference's launcher, and print the same results.

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


def _launch(pkg, n, script, *args, env=None, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.launcher", "-n", str(n), *(
            ("--device", "cpu") if pkg == "mpi_tpu_torch" else ()),
         script, *args], capture_output=True, text=True, cwd=ROOT,
        timeout=timeout, env=dict(env or os.environ, OMP_NUM_THREADS="1"))


def _records(out: str):
    line = [ln for ln in out.splitlines() if ln.startswith("matrix verified")]
    assert line, out[-800:]
    return sorted(line[0].split("log = ")[1].strip().split(";")[:-1])


def test_parallel_io_matches_the_reference(tmp_path):
    """4 CPU rank processes write the 8 x 8 matrix through column-block
    views and log through the shared pointer, as the reference's example
    does under its own launcher; the file's matrix is the blocks' oracle."""
    path = str(tmp_path / "matrix.bin")
    port = _launch("mpi_tpu_torch", 4, os.path.join(
        ROOT, "mpi_tpu_torch", "examples", "parallel_io.py"), "--path", path)
    ref = _launch("mpi_tpu", 4, os.path.join(ROOT, "examples",
                                             "parallel_io.py"))
    assert port.returncode == 0 and ref.returncode == 0, (
        port.stderr[-800:], ref.stderr[-800:])
    assert _records(port.stdout) == _records(ref.stdout) == [
        f"rank{r} ok" for r in range(4)]
    m = np.fromfile(path, dtype=np.float32)[:64].reshape(8, 8)
    np.testing.assert_array_equal(m, np.repeat(np.arange(1.0, 5.0), 2)[None]
                                  .repeat(8, 0))


def test_parallel_io_in_rank_threads_at_a_two_phase_size(tmp_path):
    """The aggregated (two-phase) branch at 256 x 256 on local rank
    threads: the bytes on disk are the oracle's."""
    from mpi_tpu_torch.examples import parallel_io

    path = str(tmp_path / "m.bin")
    logs = _run(lambda c: parallel_io.run(c, 256, path), 4)
    assert logs[0].count("ok;") == 4 and logs[1:] == ["", "", ""]
    m = np.fromfile(path, dtype=np.float32)[:256 * 256].reshape(256, 256)
    np.testing.assert_array_equal(
        m, np.repeat(np.arange(1.0, 5.0, dtype=np.float32), 64)[None]
        .repeat(256, 0))


def test_spawn_workers_matches_the_reference():
    """One master spawns 3 workers; under ``--device cpu`` the workers
    run on the CPU, and the estimate is the reference example's."""
    from mpi_tpu_torch.examples import spawn_workers

    port = _launch("mpi_tpu_torch", 1, os.path.join(
        ROOT, "mpi_tpu_torch", "examples", "spawn_workers.py"))
    ref = _launch("mpi_tpu", 1, os.path.join(ROOT, "examples",
                                             "spawn_workers.py"))
    assert port.returncode == 0 and ref.returncode == 0, (
        port.stderr[-800:], ref.stderr[-800:])
    head = ref.stdout.strip().splitlines()[-1]
    assert head.startswith("master: pi ~= ")
    assert port.stdout.strip().splitlines()[-1] == (
        head + " on ['cpu', 'cpu', 'cpu']")
    hits = sum(spawn_workers.reference_hits(j, spawn_workers.SAMPLES)
               for j in range(spawn_workers.NWORKERS))
    total = spawn_workers.NWORKERS * spawn_workers.SAMPLES
    assert head == (f"master: pi ~= {4.0 * hits / total:.6f} from {total} "
                    f"samples across {spawn_workers.NWORKERS} spawned workers")


def test_coupled_models_match_the_reference(tmp_path, monkeypatch):
    """The ocean and atmosphere jobs as two 2-rank thread worlds of this
    process, through the name service in a private registry: bitwise the
    numpy replay, and the reference's two launched jobs print the same
    final boundaries."""
    import threading

    from mpi_tpu_torch.examples import coupled_models

    names = tmp_path / "names"
    names.mkdir(mode=0o700)
    monkeypatch.setenv("MPI_TPU_NAMESERVICE", str(names))
    got = {}

    def job(role, fn):
        got[role] = _run(fn, 2)

    ts = [threading.Thread(target=job, args=("ocean", coupled_models.ocean)),
          threading.Thread(target=job,
                           args=("atmosphere", coupled_models.atmosphere))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    for r in range(2):
        sst, air = coupled_models.oracle(r)
        np.testing.assert_array_equal(got["ocean"][r].numpy(), sst)
        np.testing.assert_array_equal(got["atmosphere"][r].numpy(), air)
    script = os.path.join(ROOT, "examples", "coupled_models.py")
    env = dict(os.environ, MPI_TPU_NAMESERVICE=str(names))
    ocean = subprocess.Popen(
        [sys.executable, "-m", "mpi_tpu.launcher", "-n", "2", script,
         "ocean"], stdout=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    atm = _launch("mpi_tpu", 2, script, "atmosphere", env=env, timeout=120)
    out, _ = ocean.communicate(timeout=120)
    assert ocean.returncode == 0 and atm.returncode == 0
    assert f"final sst[0] = {float(got['ocean'][0][0]):.3f}" in out
    assert f"final air[0] = {float(got['atmosphere'][0][0]):.3f}" in atm.stdout


def test_host_dynamic_on_cpu_rank_processes(tmp_path):
    """The card's phase 26 program on 4 CPU socket ranks at 4 MiB a rank:
    every leg checked, the steered receive in place and the copy path
    counted, and the two spawned workers on the CPU."""
    import json

    out = tmp_path / "hd"
    proc = _launch("mpi_tpu_torch", 4, os.path.join(
        ROOT, "mpi_tpu_torch", "examples", "host_dynamic.py"), "--out",
        str(out), "--mib", "4", "--n", "256", "--samples", "4096",
        "--require", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    recs = [json.load(open(out / f"rank{r}.json")) for r in range(4)]
    assert all(leg["ok"] for rec in recs for leg in rec["legs"].values())
    steered, copied = recs[1]["legs"]["steered recv"], \
        recs[1]["legs"]["copy-path recv"]
    assert [(t["recv_user_inplace"], t["recv_user_fallbacks"])
            for t in steered["turns"]] == [(1, 0), (1, 0)]
    assert [(t["recv_user_inplace"], t["recv_user_fallbacks"])
            for t in copied["turns"]] == [(0, 1), (0, 1)]
    assert recs[0]["legs"]["spawn"]["devices"] == ["cpu", "cpu"]
    assert recs[0]["legs"]["io write_at_all"]["branch"] == "independent"
