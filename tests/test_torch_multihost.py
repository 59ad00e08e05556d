"""Worlds that span processes (``mpi_tpu_torch/gpu/multihost.py``) against
the JAX package's single-process results.

One launch of two simulated hosts with two ranks each, on the CPU (gloo),
runs ``mpi_tpu_torch/examples/multihost_world.py`` through the CLI: the
reference's multi-host program (``tests/test_multihost.py:17-64``), the
``pallas_ring`` modes on numpy inputs, the node key of a host world that
spans the processes, a fused SUM's gradient and a ring-attention forward.
Their rows, put together, are held against ``mpi_tpu.tpu.run_spmd`` over 4
of the 8 virtual CPU devices ``tests/conftest.py`` forces (the Pallas ring
in interpret mode):

* exact for the program's integers and float sums (integer-valued);
* bitwise for ``pallas_ring`` (float32 SUM, bfloat16 MAX): both fold in the
  TPU ring's order (see ``tests/test_torch_ring.py``); the MAX input holds a
  NaN, which must land in the same places;
* the gradient and the attention rows equal the one-process port's
  bitwise (the same one-process rule runs on the gathered world).

The launcher's exit codes, its timeout and ``hybrid_mesh``'s single-granule
branch need no torch import in their processes.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mpi_tpu
from mpi_tpu.tpu import run_spmd as ref_run_spmd
from mpi_tpu.tpu.multihost import hybrid_mesh as ref_hybrid_mesh
from mpi_tpu_torch.examples import multihost_world as mw
from mpi_tpu_torch.gpu import TorchCommunicator, multihost, peers, primitives
from mpi_tpu_torch.gpu import run_spmd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS, LOCAL = 2, 2
P = HOSTS * LOCAL
BLOCK = 1001           # allgather block; allreduce rows are P * BLOCK long
HALF = 2053            # the bfloat16 MAX row


def _spread(shape, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * 10.0 ** rs.uniform(-4, 8, size=shape)).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two-process world's rows and records (one CLI launch)."""
    tmp = tmp_path_factory.mktemp("multihost")
    x = _spread((P, P * BLOCK), 1)
    xh = np.array(jnp.asarray(_spread((P, HALF), 2), jnp.bfloat16)
                  .astype(jnp.float32))
    xh[1, 5] = np.nan  # MAX propagates NaN
    np.savez(tmp / "inputs.npz", x=x, xh=xh)
    rdv = tmp / "rdv"
    rdv.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.gpu.multihost", "-n", str(HOSTS),
         "--devices-per-host", str(LOCAL), "--device", "cpu", "--timeout", "240",
         os.path.join(REPO, "mpi_tpu_torch", "examples", "multihost_world.py"),
         "--out", str(tmp / "out"), "--inputs", str(tmp / "inputs.npz"),
         "--rdv", str(rdv), "--save-rows"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    recs = [json.loads((tmp / "out" / f"proc{q}.json").read_text())
            for q in range(HOSTS)]
    rows = [torch.load(tmp / "out" / f"proc{q}.pt") for q in range(HOSTS)]
    joined = {k: (torch.cat([r[k] for r in rows]) if k != "worker" else
                  [torch.cat([r[k][i] for r in rows]) for i in range(4)])
              for k in rows[0]}
    return {"x": x, "xh": xh, "recs": recs, "rows": joined}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _ref(fn, *args):
    out = ref_run_spmd(fn, *args, nranks=P, check_vma=False)
    return jax.tree.map(np.asarray, out)


def test_each_process_holds_its_ranks(world):
    for q, rec in enumerate(world["recs"]):
        assert (rec["process"], rec["processes"], rec["ranks"]) == (q, HOSTS, P)
        assert (rec["first"], rec["count"], rec["device"]) == (q * LOCAL, LOCAL, "cpu")
        assert rec["open_mappings_after"] == 0
        # each process gathers the whole world: P/count times its own bytes
        assert rec["stats"]["world_bytes"] == HOSTS * rec["stats"]["local_bytes"]


def test_worker_program_matches_the_reference(world):
    def prog(comm):
        r = comm.rank
        total = comm.allreduce(r, algorithm="fused")
        ring = comm.allreduce(jnp.zeros(8) + r, algorithm="ring")
        nbr = comm.shift((r * 10.0)[None], offset=1, wrap=True)
        sub = comm.split_by(lambda i: i % 2)
        subtotal = sub.allreduce(r, algorithm="fused")
        return total, ring.sum(), nbr, subtotal[None]

    want = _ref(prog)
    got = world["rows"]["worker"]
    assert [g.shape[0] for g in got] == [P] * 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().reshape(w.shape), w)


@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter", "allgather",
                                  "allreduce_bf16_max"])
def test_pallas_ring_across_processes_is_bitwise_the_reference(world, mode):
    x, xh = world["x"], world["xh"]
    if mode == "allreduce":
        want = _ref(lambda c, v: c.allreduce(v[c.rank], algorithm="pallas_ring"), x)
    elif mode == "reduce_scatter":
        want = _ref(lambda c, v: c.reduce_scatter(
            v[c.rank].reshape(P, BLOCK), algorithm="pallas_ring"), x)
    elif mode == "allgather":
        want = _ref(lambda c, v: c.allgather(v[c.rank, :BLOCK],
                                             algorithm="pallas_ring"), x)
    else:
        want = _ref(lambda c, v: c.allreduce(v[c.rank], op=mpi_tpu.ops.MAX,
                                             algorithm="pallas_ring"),
                    jnp.asarray(xh, jnp.bfloat16))
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = world["rows"][mode].float().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(_bits(np.nan_to_num(got)), _bits(np.nan_to_num(want)))


def test_node_key_is_the_process_and_splits_by_it(world):
    """The repair: a host world of 2 processes x 2 rank threads keys its
    nodes by process ([0, 0, 1, 1]), as the reference's process index
    does, and ``split_hierarchical`` checked in every rank (intra groups
    of 2, a leaders communicator of 2 on the leaders only)."""
    for rec in world["recs"]:
        assert rec["node_key"] == [0, 0, 1, 1]


def test_hybrid_mesh_across_processes(world):
    for rec in world["recs"]:
        h = rec["hybrid"]
        assert h["ranks"] == [[0, 1], [2, 3]]
        assert h["process_index"] == [[0, 0], [1, 1]]
        # column sums of arange(4).reshape(2, 2)
        assert h["dcn_allreduce"] == [2.0, 4.0]


def test_gradient_and_attention_equal_the_one_process_port(world):
    gx, gw, qkv = mw.small_inputs(0, P)
    grad = run_spmd(mw.grad_program, gx, gw, nranks=P, device="cpu")
    assert torch.equal(world["rows"]["grad"], grad)
    # JAX's pvary transpose: the replicated w gets the sum over the ranks
    s = (gx * gw).sum(0)
    torch.testing.assert_close(grad[0], 2 * (s[None] * gx).sum(0), rtol=1e-5, atol=1e-6)
    att = run_spmd(mw.attention_program, *qkv, nranks=P, device="cpu")
    assert torch.equal(world["rows"]["attention"], att)


# ---- in one process ------------------------------------------------------------


def test_hybrid_mesh_single_granule(monkeypatch):
    """``tests/test_multihost.py:143-160``: an all-ones dcn shape is the
    plain grid (the reference's over its 8 devices), and mismatched shapes
    raise."""
    monkeypatch.setenv(multihost.ENV_RANKS, "8")
    mesh = multihost.hybrid_mesh((1, 8), (1, 1), ("dp", "mp"))
    assert mesh.shape == {"dp": 1, "mp": 8}
    ref = ref_hybrid_mesh((1, len(jax.devices())), (1, 1), ("dp", "mp"))
    assert mesh.ranks.tolist() == [[d.id for d in row] for row in ref.devices]
    assert mesh.span is None and mesh.comm("mp").axis_index_groups is None
    assert mesh.comm("dp").axis_index_groups == [[r] for r in range(8)]
    with pytest.raises(ValueError, match="one entry per mesh axis"):
        multihost.hybrid_mesh((2,), (1, 1), ("a", "b"))
    with pytest.raises(ValueError, match="needs 4 ranks"):
        multihost.hybrid_mesh((2, 2), (1, 1), ("a", "b"))


def test_without_a_card_a_spanning_world_needs_the_cpu_named(monkeypatch):
    """No fallback: with neither a card nor ``device="cpu"`` (nor the
    launcher's ``MPI_TPU_DEVICE``) a world that spans processes raises as
    ``resolve_device`` does; without the process group it raises too."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.delenv("MPI_TPU_DEVICE", raising=False)
    comm = TorchCommunicator(4, span=primitives.Span(0, 2))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        run_spmd(lambda c: c.allreduce(c.rank), comm=comm)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        multihost.device()
    with pytest.raises(RuntimeError, match="init_distributed"):
        run_spmd(lambda c: c.allreduce(c.rank), comm=comm, device="cpu")
    assert not peers._EXCHANGES


_EXIT = textwrap.dedent("""
    import os, sys, time
    if os.environ["MPI_TPU_PROC_ID"] == "1":
        while not os.path.exists(sys.argv[1]):  # host 0 is up
            time.sleep(0.02)
        sys.exit(3)
    open(sys.argv[1] + ".tmp", "w").write(str(os.getpid()))
    os.replace(sys.argv[1] + ".tmp", sys.argv[1])
    time.sleep(120)
""")


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _pid_of(path):
    import time

    for _ in range(500):
        if path.exists() and path.read_text():
            return int(path.read_text())
        time.sleep(0.02)
    raise TimeoutError(path)


def test_cli_returns_the_failing_hosts_code_and_stops_the_others(tmp_path):
    script = tmp_path / "exit3.py"
    script.write_text(_EXIT)
    pid_file = tmp_path / "pid0"
    # host 0 writes its pid and sleeps until it is stopped; then host 1 exits 3
    rc = multihost.main(["-n", "2", "--devices-per-host", "1", str(script),
                         str(pid_file)])
    assert rc == 3
    assert _gone(int(pid_file.read_text()))


def test_cli_times_out_and_stops_every_host(tmp_path):
    script = tmp_path / "sleep.py"
    script.write_text("import os, sys, time\n"
                      "open(sys.argv[1] + os.environ['MPI_TPU_PROC_ID'], 'w')"
                      ".write(str(os.getpid()))\n"
                      "time.sleep(120)\n")
    with pytest.raises(TimeoutError):
        multihost.main(["-n", "2", "--timeout", "3", str(script),
                        str(tmp_path / "pid")])
    for q in range(2):
        assert _gone(_pid_of(tmp_path / f"pid{q}"))


def test_launcher_environment(tmp_path):
    """PYTHONPATH is the repository root; the coordinator, the process
    count and id, the ranks per process and the device travel in the
    environment."""
    script = tmp_path / "env.py"
    script.write_text("import json, os, sys\n"
                      "keys = ('PYTHONPATH', 'MPI_TPU_COORD', 'MPI_TPU_NPROCS', "
                      "'MPI_TPU_PROC_ID', 'MPI_TPU_RANKS_PER_HOST', 'MPI_TPU_DEVICE')\n"
                      "json.dump({k: os.environ.get(k) for k in keys}, "
                      "open(sys.argv[1] + os.environ['MPI_TPU_PROC_ID'], 'w'))\n")
    assert multihost.launch_sim_hosts(2, [str(script), str(tmp_path / "env")],
                                      devices_per_host=3, device="cpu",
                                      timeout=60) == 0
    envs = [json.loads((tmp_path / f"env{q}").read_text()) for q in range(2)]
    assert [e["MPI_TPU_PROC_ID"] for e in envs] == ["0", "1"]
    for e in envs:
        assert e["PYTHONPATH"] == REPO
        assert e["MPI_TPU_NPROCS"] == "2" and e["MPI_TPU_RANKS_PER_HOST"] == "3"
        assert e["MPI_TPU_DEVICE"] == "cpu"
        assert e["MPI_TPU_COORD"].startswith("127.0.0.1:")
