"""mpi_tpu_torch and chip_smoke.py import nothing of JAX or of the JAX
package: proven in a subprocess whose import system refuses ``jax``,
``jaxlib``, ``mpi_tpu`` and ``mpi_tpu.*`` (but not ``mpi_tpu_torch``),
which imports every module of the port and runs the multi-parallel dry
run, its trace, a checkpoint, a profile, the ring-attention plans of
every head dim (``kernel_smem_bytes`` reads the CUDA sources, the forms
above d = 256 too) and a d = 512 world, a nonblocking collective on a
fault-tolerant local world with the progress engine, the one-process
meshes of ``gpu/multihost.py`` (whose peer exchange, ``gpu/peers.py``, is
imported with the rest), an exploration of the protocol model
(``gpu/ring_model.py``) and a parse of the evidence writer
(``tools/gpu_evidence.py``), an arena
allreduce over the shared-memory rings (built from the port's own
``native/shmring.cpp`` into ``mpi_tpu_torch/_build/``; no library of
``mpi_tpu/native`` is mapped), and the host paths of the process
checkpoints, graph topologies, hierarchical splits, intercommunicators,
the flat ``api`` and the ``master_worker`` example, on the CPU, and a
resident world server whose one ``-m mpi_tpu_torch.serve --worker``
process starts under the same import block (a ``sitecustomize`` on its
``PYTHONPATH``) and serves a lease."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "mpi_tpu")

_BLOCK = r"""
import importlib.abc, sys

BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
""" % (BLOCKED,)

_CHILD = _BLOCK + r"""
import importlib, os, pkgutil
_BLOCK = %r
import torch
import mpi_tpu_torch
names = ["mpi_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    mpi_tpu_torch.__path__, "mpi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
NEW = ["mpi_tpu_torch.window", "mpi_tpu_torch.gpu.window", "mpi_tpu_torch.datatypes",
       "mpi_tpu_torch.topology", "mpi_tpu_torch.examples.jacobi2d",
       "mpi_tpu_torch.examples.pipeline", "mpi_tpu_torch.examples.moe",
       "mpi_tpu_torch.examples.ulysses_attention",
       "mpi_tpu_torch.examples.data_parallel", "mpi_tpu_torch.entry",
       "mpi_tpu_torch.aot", "mpi_tpu_torch.checkpoint", "mpi_tpu_torch.profiling",
       "mpi_tpu_torch.progress", "mpi_tpu_torch.nbc", "mpi_tpu_torch.ft",
       "mpi_tpu_torch.membership", "mpi_tpu_torch.transport.faulty",
       "mpi_tpu_torch.examples.host_ft", "mpi_tpu_torch.compress",
       "mpi_tpu_torch.tuning", "mpi_tpu_torch.native.build",
       "mpi_tpu_torch.transport.shm", "mpi_tpu_torch.coll_sm",
       "mpi_tpu_torch.shmwin", "mpi_tpu_torch.tools.tune",
       "mpi_tpu_torch.examples.host_shm", "mpi_tpu_torch.api",
       "mpi_tpu_torch.mpi4", "mpi_tpu_torch.intercomm",
       "mpi_tpu_torch.examples.master_worker",
       "mpi_tpu_torch.examples.session_library",
       "mpi_tpu_torch.examples.datatypes_demo", "mpi_tpu_torch.spawn",
       "mpi_tpu_torch.io", "mpi_tpu_torch.examples.spawn_workers",
       "mpi_tpu_torch.examples.coupled_models",
       "mpi_tpu_torch.examples.parallel_io",
       "mpi_tpu_torch.examples.host_dynamic", "mpi_tpu_torch.serve",
       "mpi_tpu_torch.telemetry.metrics",
       "mpi_tpu_torch.examples.host_serve", "mpi_tpu_torch.federation",
       "mpi_tpu_torch.federation_store",
       "mpi_tpu_torch.examples.host_federation", "mpi_tpu_torch.gpu.multihost",
       "mpi_tpu_torch.gpu.peers", "mpi_tpu_torch.examples.multihost_world",
       "mpi_tpu_torch.gpu.ring_model", "mpi_tpu_torch.tools.gpu_evidence"]
assert not set(NEW) - set(names), set(NEW) - set(names)
# the protocol model (the standard library only) and the evidence writer
from mpi_tpu_torch.gpu import ring_model
assert ring_model.explore_all(2, 1, rot=0, allgather=True) > 10
from mpi_tpu_torch.tools import gpu_evidence
assert gpu_evidence.parse_tier("1 passed in 0.10s")["summary"] == {"passed": 1}
# worlds that span processes: the meshes of one process need no process group
from mpi_tpu_torch.gpu import multihost
assert multihost.global_mesh().comm().span is None
assert multihost.hybrid_mesh((1, 1), (1, 1), ("dcn", "ici")).shape == {"dcn": 1, "ici": 1}
from mpi_tpu_torch.entry import dryrun_multichip, lower_multichip
dryrun_multichip(8, device="cpu")
assert len(lower_multichip(8, "pallas_ring", device="cpu").graph.nodes) > 100
import tempfile
from mpi_tpu_torch import checkpoint, profiling
with tempfile.TemporaryDirectory() as tmp:
    checkpoint.save_sharded(tmp, {"w": torch.ones(2)})
    assert torch.equal(checkpoint.load_sharded(tmp, {"w": torch.zeros(2)})["w"],
                       torch.ones(2))
    with profiling.trace(tmp):
        torch.ones(3).sum()
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), \
    [m for m in sys.modules if m.split(".")[0] in BLOCKED]

# the nonblocking engine and fault tolerance on the host layer
got = mpi_tpu_torch.run(lambda c: float(c.iallreduce(torch.ones(2)).wait()[0]),
                        backend="local", nranks=3, device="cpu",
                        progress="thread", fault_tolerance=True)
assert got == [3.0, 3.0, 3.0], got
# the same-host data plane: the port's own ring, built into its _build/
from mpi_tpu_torch.native import build as native_build
from mpi_tpu_torch.transport.shm import run_shm
got = run_shm(lambda c: float(c.allreduce(torch.ones(2), algorithm="sm")[0]),
              2, device="cpu")
assert got == [2.0, 2.0], got
so = native_build.ensure_built()
assert so.startswith(str(native_build.BUILD_DIR)), so
with open("/proc/self/maps") as f:
    libs = {line.split()[-1] for line in f if line.strip().endswith(".so")}
assert so in libs, so
assert not [p for p in libs if "/mpi_tpu/native/" in p], libs
# the process checkpoints, the host graph topologies, the hierarchical
# splits and the flat layer, on rank threads
from mpi_tpu_torch import api, topology
from mpi_tpu_torch.examples import master_worker

def host_prog(c):
    g = topology.dist_graph_create_adjacent(c, [(c.rank - 1) %% 4],
                                            [(c.rank + 1) %% 4])
    h = topology.HierarchicalComm(c, node_key=lambda r: r // 2)
    ic = mpi_tpu_torch.create_intercomm(c, [0, 1], [2, 3])
    with tempfile.TemporaryDirectory() as tmp:
        path = c.bcast(tmp, root=0)
        checkpoint.save(path, {"w": torch.full((2,), float(c.rank))}, c)
        back = checkpoint.load(path, c)["w"]
        c.barrier()
    return (float(g.neighbor_allgather(torch.ones(1))[0][0]),
            float(h.allreduce(torch.ones(1))[0]), float(ic.allreduce(torch.ones(1))[0]),
            float(api.MPI_Allreduce(torch.ones(1), comm=c)[0]), float(back[0]))

got = mpi_tpu_torch.run(host_prog, backend="local", nranks=4, device="cpu")
assert got == [(1.0, 4.0, 2.0, 4.0, float(r)) for r in range(4)], got
assert len(mpi_tpu_torch.run(lambda c: master_worker.run(c, 5), backend="local",
                             nranks=3, device="cpu")[0]) == 5
# MPI-IO, user-buffer steering and the port/name plumbing of spawn
from mpi_tpu_torch import io as mio, spawn
with tempfile.TemporaryDirectory() as tmp:
    with mio.file_open(mpi_tpu_torch.comm_self(device="cpu"), tmp + "/f.bin",
                       mio.MODE_CREATE | mio.MODE_RDWR) as f:
        f.set_view(etype=torch.float32, datarep="external32")
        f.write_at(0, torch.arange(4.0))
        assert torch.equal(f.read_at(0, 4), torch.arange(4.0))

def steered(c):
    if c.rank == 0:
        c.send(torch.ones(4096), dest=1, tag=3)
        return True
    buf = torch.zeros(4096)
    return c.irecv(0, 3, buf=buf).wait() is buf or bool((buf == 1).all())

assert all(run_shm(steered, 2, device="cpu"))
port = spawn.open_port()
spawn.close_port(port)
x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
out = mpi_tpu_torch.run(lambda c, d: c.allreduce(d[c.rank], algorithm="pallas_ring"),
                        x, nranks=8, device="cpu")
assert torch.equal(out[0], x.sum(0)), out
# the attention forms above d = 256: their plans are read from
# csrc/attention_wide.cu and attention_bwd_wide.cu, and a d = 512 world runs
# the plain version on the CPU
from mpi_tpu_torch.gpu import attention
for dt in (torch.float32, torch.bfloat16):
    assert max(attention.kernel_smem_bytes(512, dt).values()) <= attention._SMEM_LIMIT
w = torch.randn(2, 2, 8, 512)
assert attention.ring_attention_world(w, w, w, causal=True).shape == w.shape
assert attention.WIDE_LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
# the resident world server: its worker process starts with the same
# block installed by a sitecustomize, which leaves a mark that it ran
from mpi_tpu_torch import serve
with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/sitecustomize.py", "w") as f:
        f.write(_BLOCK + "open(%%r + '/blocked.' + str(__import__('os').getpid()), 'w')"
                "\n" %% tmp)
    env = {"MPI_TPU_DEVICE": "cpu", "PYTHONPATH": tmp + ":" + %r}
    with serve.WorldServer(pool_size=1, env_extra=env) as srv:
        client = mpi_tpu_torch.connect(srv)
        assert client.run(serve.job_allreduce, 8, nranks=1, timeout=60) == 1.0
        client.close()
    assert [n for n in os.listdir(tmp) if n.startswith("blocked.")], os.listdir(tmp)
if not torch.cuda.is_available():
    try:
        mpi_tpu_torch.run(lambda c: c.rank, nranks=2)
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("run() without a device must not fall back to the CPU")
print("imported", len(names), "modules")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _CHILD % (_BLOCK, str(ROOT))], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [ROOT / "chip_smoke.py",
                                       *(ROOT / "mpi_tpu_torch").rglob("*.py")]))
def test_no_jax_import_statements(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, (path, name)


def test_chip_smoke_alone_fails(tmp_path):
    """Without the card, or without the rest of the repository, the smoke
    test exits non-zero and prints no ok line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
