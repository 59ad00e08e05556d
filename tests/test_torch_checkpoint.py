"""Sharded checkpoints (``mpi_tpu_torch.checkpoint``) against the JAX
package's orbax path (``mpi_tpu/checkpoint.py:164-190``) on the CPU: the
same numpy state through both round trips, as
``tests/test_checkpoint.py:95-110`` runs it on the 8 CPU devices, comes
back bitwise equal, and keeps its layout.  A save torn before its manifest
is committed leaves the previous checkpoint loadable; a template that does
not match raises, naming the tensor.  Checkpoints move bytes, so every
comparison is exact.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as Pspec

import mpi_tpu_torch
from mpi_tpu import checkpoint as jck
from mpi_tpu.tpu import default_mesh
from mpi_tpu_torch import checkpoint as ck
from mpi_tpu_torch.checkpoint import Layout, Sharded

MESH_2X4 = {"dp": 2, "mp": 4}


def _jax_round_trip(path, arrays, specs, mesh):
    """Save and load through the reference; returns the restored arrays."""
    state, tpl = {}, {}
    for k, a in arrays.items():
        if specs[k] is None:
            state[k], tpl[k] = jnp.asarray(a), jnp.zeros(a.shape, a.dtype)
        else:
            sh = NamedSharding(mesh, Pspec(*specs[k]))
            state[k] = jax.device_put(jnp.asarray(a), sh)
            tpl[k] = jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=sh)
    jck.save_sharded(str(path), state)
    got = jck.load_sharded(str(path), tpl)
    for k, spec in specs.items():
        if spec is not None:
            assert got[k].sharding == tpl[k].sharding
    return {k: np.asarray(v) for k, v in got.items()}


def _port_round_trip(path, arrays, layouts, dtype=None):
    state = {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}
    if dtype is not None:
        state = {k: v.to(dtype) for k, v in state.items()}
    state = {k: v if layouts[k] is None else Sharded(v, layouts[k])
             for k, v in state.items()}
    nbytes = ck.save_sharded(str(path), state)
    tpl = {k: Sharded(torch.empty_like(v.tensor), v.layout) if isinstance(v, Sharded)
           else torch.empty_like(v) for k, v in state.items()}
    got = ck.load_sharded(str(path), tpl)
    for k, v in got.items():
        assert isinstance(v, Sharded) == (layouts[k] is not None), k
        if layouts[k] is not None:
            assert v.layout == layouts[k]
    return state, got, nbytes


def _tensor(v):
    return v.tensor if isinstance(v, Sharded) else v


def test_round_trip_matches_reference_world_layout(tmp_path):
    """tests/test_checkpoint.py:95: a global array sharded over the world
    axis and a replicated one; the port's world tensor is the same array
    as rank-stacked shards."""
    n = len(jax.devices())
    rng = np.random.RandomState(0)
    arrays = {"w": rng.randn(n, 4).astype(np.float32), "b": np.ones(3, np.float32)}
    want = _jax_round_trip(tmp_path / "jax", arrays, {"w": ("world",), "b": None},
                           default_mesh())
    _, got, nbytes = _port_round_trip(tmp_path / "port", arrays,
                                      {"w": Layout.world(n, 2), "b": None})
    for k in arrays:
        np.testing.assert_array_equal(_tensor(got[k]).numpy(), want[k])
        np.testing.assert_array_equal(_tensor(got[k]).numpy(), arrays[k])
    assert nbytes == sum(a.nbytes for a in arrays.values())


@pytest.mark.parametrize("spec", [(None, "mp"), ("mp", None), ("dp", "mp"), (None, None)])
def test_round_trip_matches_reference_2x4_layouts(tmp_path, spec):
    """The 2-D step's layouts (w1 P(None, "mp"), w2 P("mp", None)) and two
    more on the 2 x 4 mesh: bitwise equal to the reference's round trip;
    a shard replicated over an axis is written once."""
    rng = np.random.RandomState(1)
    arrays = {"w": rng.randn(8, 16).astype(np.float32)}
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "mp"))
    want = _jax_round_trip(tmp_path / "jax", arrays, {"w": spec}, mesh)
    layout = Layout(MESH_2X4, spec)
    _, got, nbytes = _port_round_trip(tmp_path / "port", arrays, {"w": layout})
    np.testing.assert_array_equal(got["w"].tensor.numpy(), want["w"])
    np.testing.assert_array_equal(got["w"].tensor.numpy(), arrays["w"])
    shards = layout.shards((8, 16))
    split = [MESH_2X4[a] for a in spec if a is not None]
    assert len(shards) == int(np.prod(split))
    assert sorted(r for _, owners in shards for r in owners) == list(range(8))
    assert nbytes == arrays["w"].nbytes  # each element once, no replica twice
    manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
    files = os.listdir(tmp_path / "port" / f"gen{manifest['gen']}")
    assert len(files) == len(shards)


def test_world_tensor_from_run_spmd_round_trips(tmp_path):
    """A [P, ...] world as run_spmd returns it, bfloat16 and float32."""
    out = mpi_tpu_torch.run(
        lambda comm: (comm.rank.to(torch.float32) + torch.arange(6.0)).reshape(2, 3),
        nranks=8, device="cpu")
    for dtype in (torch.float32, torch.bfloat16):
        world = out.to(dtype)
        ck.save_sharded(str(tmp_path), {"h": Sharded(world, Layout.world(8, 3))})
        got = ck.load_sharded(str(tmp_path), {"h": Sharded(torch.zeros_like(world),
                                                           Layout.world(8, 3))})
        assert got["h"].tensor.dtype == dtype
        assert torch.equal(got["h"].tensor, world)


def test_torn_save_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    """A crash before the manifest's rename (the commit) leaves the
    previous checkpoint loadable; the next clean save commits and sweeps
    the orphaned generation (tests/test_checkpoint.py:113)."""
    layout = Layout.world(8, 2)
    first = torch.arange(16.0).reshape(8, 2)
    tpl = {"w": Sharded(torch.empty(8, 2), layout)}
    ck.save_sharded(str(tmp_path), {"w": Sharded(first, layout)})
    real_replace = os.replace

    def crash(src, dst):
        if str(dst).endswith("manifest.json"):
            raise RuntimeError("crash before commit")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", crash)
    with pytest.raises(RuntimeError, match="crash before commit"):
        ck.save_sharded(str(tmp_path), {"w": Sharded(first + 100, layout)})
    monkeypatch.setattr(os, "replace", real_replace)
    assert torch.equal(ck.load_sharded(str(tmp_path), tpl)["w"].tensor, first)
    assert sorted(os.listdir(tmp_path)) == ["gen0", "gen1", "manifest.json",
                                            "manifest.json.tmp"]
    ck.save_sharded(str(tmp_path), {"w": Sharded(first + 200, layout)})
    assert torch.equal(ck.load_sharded(str(tmp_path), tpl)["w"].tensor, first + 200)
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("gen")) == ["gen1"]


def test_save_sweeps_only_its_generations(tmp_path):
    """Entries of the directory that are not a generation (``gen`` and
    digits) survive every save, whatever their names."""
    layout = Layout.world(8, 2)
    for name in ("generated", "genomes", "gen1a", "gen"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "keep.txt").write_text("user data")
    (tmp_path / "gen7").mkdir()  # an orphan of an earlier torn save
    for k in range(3):
        ck.save_sharded(str(tmp_path), {"w": Sharded(torch.full((8, 2), float(k)),
                                                      layout)})
    for name in ("generated", "genomes", "gen1a", "gen"):
        assert (tmp_path / name / "keep.txt").read_text() == "user data"
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("gen")) == [
        "gen", "gen1a", "gen2", "generated", "genomes"]


def test_load_without_a_committed_manifest_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="manifest missing"):
        ck.load_sharded(str(tmp_path), {"w": torch.zeros(2)})


@pytest.mark.parametrize("bad,match", [
    ({"w": Sharded(torch.empty(8, 3), Layout.world(8, 2))}, r"\['w'\].*\(8, 2\)"),
    ({"w": Sharded(torch.empty(8, 2, dtype=torch.float64), Layout.world(8, 2))},
     r"\['w'\].*float64"),
    ({"w": Sharded(torch.empty(8, 2), Layout(MESH_2X4, ("dp", None)))},
     r"\['w'\].*Layout"),
    ({"w": torch.empty(8, 2)}, r"\['w'\]"),
    ({"v": Sharded(torch.empty(8, 2), Layout.world(8, 2))}, r"\['w'\]"),
])
def test_template_mismatch_raises_naming_the_tensor(tmp_path, bad, match):
    ck.save_sharded(str(tmp_path), {"w": Sharded(torch.zeros(8, 2), Layout.world(8, 2))})
    with pytest.raises(ValueError, match=match):
        ck.load_sharded(str(tmp_path), bad)


def test_layout_diagnoses():
    with pytest.raises(ValueError, match="not in mesh"):
        Layout(MESH_2X4, ("tp", None))
    with pytest.raises(ValueError, match="two dims over one axis"):
        Layout(MESH_2X4, ("mp", "mp"))
    with pytest.raises(ValueError, match="does not split evenly"):
        Layout(MESH_2X4, (None, "mp")).shards((8, 6))
    with pytest.raises(TypeError, match="not a tensor"):
        ck.save_sharded("/nonexistent-never-created", {"step": 3})
