"""mpi_tpu_torch and chip_smoke.py import nothing of JAX or of the JAX
package: proven in a subprocess whose import system refuses ``jax``,
``jaxlib``, ``mpi_tpu`` and ``mpi_tpu.*`` (but not ``mpi_tpu_torch``),
which imports every module of the port and runs the multi-parallel dry
run, its trace, a checkpoint and a profile on the CPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "mpi_tpu")

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
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
       "mpi_tpu_torch.aot", "mpi_tpu_torch.checkpoint", "mpi_tpu_torch.profiling"]
assert not set(NEW) - set(names), set(NEW) - set(names)
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

x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
out = mpi_tpu_torch.run(lambda c, d: c.allreduce(d[c.rank], algorithm="pallas_ring"),
                        x, nranks=8, device="cpu")
assert torch.equal(out[0], x.sum(0)), out
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
    res = subprocess.run([sys.executable, "-c", _CHILD % (BLOCKED,)], cwd=ROOT,
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
