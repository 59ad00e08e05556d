"""The port's process-backend checkpoints (``checkpoint.save`` /
``exists`` / ``load``) against the reference's.

Held unchanged on the port (``tests/test_torch_host_ref.py``: the
reference's inputs, oracles and assertions on ``run_local(...,
device="cpu")``): ``tests/test_checkpoint.py:13``, ``:27``, ``:42`` and
``:114`` (a crashed re-save keeps the prior generation), and
``tests/test_fault_tolerance.py:221`` and ``:303`` (``agree=True``
withholds the commit).  ``tests/test_checkpoint.py:61`` (resume equals a
straight run) uses the reference's JAX Jacobi step, so it runs here with
the port's ``examples/jacobi.py`` step, bitwise as the reference asserts.
``tests/test_failure_story.py:152`` (socket and shm) and ``:172`` are
held with the port's launcher and a port program of the same story
(``--device cpu``).  The two packages also read each other's layout: a
directory the reference's ``save`` wrote loads on the port with the same
leaves (numpy stays numpy), bitwise.  The card case (tensors restored on
``cuda:``) is in ``tests/test_torch_gpu_real.py``.
"""

import json
import os
import textwrap

import numpy as np
import pytest
import torch

import mpi_tpu_torch
from mpi_tpu import checkpoint as ref_ck
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import checkpoint as ck
from mpi_tpu_torch.examples.jacobi import jacobi_step
from mpi_tpu_torch.launcher import launch
from tests.test_torch_host_local import assert_same
from tests.test_torch_host_ref import port_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

globals().update(port_cases("test_checkpoint", only=(
    "test_process_checkpoint_roundtrip", "test_partial_checkpoint_rejected",
    "test_world_size_mismatch_rejected",
    "test_resave_crash_keeps_prior_generation")))
globals().update(port_cases("test_fault_tolerance", only=(
    "test_checkpoint_save_agree_demo",
    "test_checkpoint_agree_refuses_commit_even_after_ack")))


def assert_same_tree(a, b, where=""):
    """Bitwise equality of two pytrees (dicts, lists, tuples, tensors as
    numpy, arrays, scalars), with each leaf's type kind and dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a, b)
        for k in a:
            assert_same_tree(a[k], b[k], f"{where}.{k}")
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{where}[{i}]")
        return
    assert_same(a, b, where)


def run(prog, n):
    return mpi_tpu_torch.run(prog, backend="local", nranks=n, device="cpu")


def _state(rank):
    rng = np.random.default_rng(rank)
    return {
        "w": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
        "h": torch.from_numpy(rng.standard_normal(5)).to(torch.bfloat16),
        "ids": torch.arange(6, dtype=torch.int64) * rank,
        "mask": torch.tensor([True, False, rank % 2 == 0]),
        "scalar_t": torch.tensor(2.5 + rank),
        "view": torch.arange(10.0)[2:9:3],  # strided view of a larger storage
        "np": rng.standard_normal(3),
        "np_i": np.arange(4, dtype=np.int32) + rank,
        "step": 7 + rank, "lr": 0.125, "name": f"r{rank}",
        "nested": [(rank, "a"), {"k": torch.ones(2, dtype=torch.float16)}],
    }


def test_mixed_state_round_trips_bitwise(tmp_path):
    """Tensors (float32, bfloat16, int64, bool, 0-d, a strided view),
    numpy arrays and Python objects: each leaf back with its type, dtype,
    shape and bytes; tensors on the rank's device (the CPU here)."""
    path = str(tmp_path / "ck")

    def prog(c):
        ck.save(path, _state(c.rank), c)
        return ck.exists(path), ck.load(path, c)

    for r, (ok, got) in enumerate(run(prog, 3)):
        assert ok
        want = _state(r)
        assert got.keys() == want.keys()
        for k in want:
            assert type(got[k]) is type(want[k]), k
        assert_same_tree(want, got, f"rank {r}")
        assert got["view"].is_contiguous() and got["w"].device.type == "cpu"
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f) == {"nranks": 3, "format": 2, "gen": 0}
    assert sorted(os.listdir(path)) == ["gen0", "manifest.json"]


def test_layout_and_generations_match_the_reference(tmp_path):
    """Three saves of the same numpy state in each package: the same files
    (gen2 committed, older generations swept) and manifests."""
    def prog_for(m_ck, path):
        def prog(c):
            for k in range(3):
                m_ck.save(path, {"k": k, "x": np.full(2, float(c.rank))}, c)
            return m_ck.load(path, c)
        return prog

    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = ref_run_local(prog_for(ref_ck, a), 2)
    got = run(prog_for(ck, b), 2)
    assert_same_tree(ref, got)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == ["gen2", "manifest.json"]
    assert open(os.path.join(a, "manifest.json")).read() == \
        open(os.path.join(b, "manifest.json")).read()
    assert sorted(os.listdir(os.path.join(b, "gen2"))) == ["rank0", "rank1"]


def test_port_loads_a_checkpoint_the_reference_wrote(tmp_path):
    """The host layer's counterpart of ``interop.params_from_numpy``: the
    reference's save, the port's exists and load, the same leaves."""
    path = str(tmp_path / "ck")

    def state(rank):
        rng = np.random.default_rng(10 + rank)
        return {"w": rng.standard_normal((4, 2)).astype(np.float32),
                "step": 3, "tag": ("x", rank)}

    ref_run_local(lambda c: ref_ck.save(path, state(c.rank), c), 2)
    assert ck.exists(path)
    for r, got in enumerate(run(lambda c: ck.load(path, c), 2)):
        assert isinstance(got["w"], np.ndarray)
        assert_same_tree(state(r), got, f"rank {r}")


def test_resume_equivalence_jacobi(tmp_path):
    """``tests/test_checkpoint.py:61`` with the port's Jacobi step: 50
    iterations, save, load, 50 more equals 100 straight, bitwise."""
    path = str(tmp_path / "ck")

    def grid():
        g = torch.zeros((16, 8), dtype=torch.float64)
        g[0, :] = 1.0
        return g

    def straight(c):
        g = grid()
        for _ in range(100):
            g = jacobi_step(c, g)
        return g

    def resumed(c):
        g = grid()
        for _ in range(50):
            g = jacobi_step(c, g)
        ck.save(path, {"grid": g}, c)
        g2 = ck.load(path, c)["grid"]
        for _ in range(50):
            g2 = jacobi_step(c, g2)
        return g2

    for x, y in zip(run(straight, 2), run(resumed, 2)):
        assert torch.equal(x, y)


RESTART_WORKER = textwrap.dedent("""
    import os
    import torch
    import mpi_tpu_torch
    from mpi_tpu_torch import checkpoint

    comm = mpi_tpu_torch.init()
    ckpt = os.path.join({ckpt!r}, "state")
    state = (checkpoint.load(ckpt, comm) if checkpoint.exists(ckpt)
             else {{"step": 0, "acc": torch.zeros(4, dtype=torch.float64,
                                                    device=comm.device)}})
    assert state["acc"].device == comm.device
    for step in range(state["step"], 6):
        state = {{"step": step + 1, "acc": state["acc"] + comm.rank + step}}
        checkpoint.save(ckpt, state, comm)
        if step == 2 and os.environ["MPI_TPU_ATTEMPT"] == "0" \\
                and comm.rank == 1:
            os._exit(41)  # a crash mid-run on the first attempt
    total = comm.allreduce(state["acc"].sum())
    if comm.rank == 0:
        with open(os.path.join({ckpt!r}, "result.txt"), "w") as f:
            f.write(f"{{state['step']}} {{float(total)}}")
    mpi_tpu_torch.finalize()
""")


@pytest.mark.parametrize("backend", ["socket", "shm"])
def test_restart_resumes_from_checkpoint(tmp_path, backend):
    """``tests/test_failure_story.py:152``: rank 1 dies on attempt 0, the
    launcher relaunches the world, which resumes from the last committed
    generation and ends with the crash-free state (the reference's
    oracle, exactly)."""
    script = tmp_path / "worker.py"
    script.write_text(RESTART_WORKER.format(ckpt=str(tmp_path)))
    rc = launch(2, [str(script)], timeout=120.0, backend=backend, restarts=2,
                device="cpu", env_extra={"OMP_NUM_THREADS": "1"})
    assert rc == 0
    step, total = (tmp_path / "result.txt").read_text().split()
    assert step == "6"
    assert float(total) == sum(4.0 * (r + s) for r in (0, 1) for s in range(6))


def test_restarts_exhausted_propagates_failure(tmp_path):
    """``tests/test_failure_story.py:172``."""
    script = tmp_path / "always_crash.py"
    script.write_text("import os\nimport mpi_tpu_torch\n"
                      "mpi_tpu_torch.init()\nos._exit(43)\n")
    assert launch(2, [str(script)], timeout=60.0, restarts=1, device="cpu",
                  env_extra={"OMP_NUM_THREADS": "1"}) == 43
