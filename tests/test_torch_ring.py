"""The ring kernel's plain version (mpi_tpu_torch/gpu/ring.py) against the
JAX Pallas ring kernel in interpret mode (mpi_tpu/tpu/pallas_ring.py), on
the same numpy inputs.

Tolerance: bitwise, float32 and bfloat16 alike.  Both fold every element
along the same ring order (the plain version runs the TPU schedule step by
step), and a bfloat16 fold rounds once per add in both (f32 add, then
round to nearest even), so no difference is expected or allowed.  Inputs
spread magnitudes over 1e-4..1e8 so that a different fold order would show.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as PS

from mpi_tpu.tpu import default_mesh
from mpi_tpu.tpu.pallas_ring import (pallas_ring_allgather,
                                     pallas_ring_allreduce,
                                     pallas_ring_reduce_scatter)
from mpi_tpu_torch.gpu import ring
from mpi_tpu_torch.interop import to_numpy, world_from_numpy

GROUPS = {
    None: None,
    "evens": [[0, 2, 4, 6], [1, 3, 5, 7]],
    "halves": [[0, 1, 2, 3], [4, 5, 6, 7]],
    "pairs": [[0, 2], [1, 3]],
}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
MULTI = 4 * 256 * 128 * 3 + 77   # 3 tiles of 256 rows per chunk at P=4


def spread(shape, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * 10.0 ** rs.uniform(-4, 8, size=shape)).astype(np.float32)


def _jax(fn, data, jdt):
    mesh = default_mesh(data.shape[0])
    out = jax.jit(jax.shard_map(
        lambda x: fn(x[0])[None], mesh=mesh, in_specs=PS("world"),
        out_specs=PS("world"), check_vma=False))(jnp.asarray(data, jdt))
    return np.asarray(out.astype(jnp.float32))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _size(nranks, gname):
    return nranks if GROUPS[gname] is None else len(GROUPS[gname][0])


@pytest.mark.parametrize("nranks,dt,op,gname,tile_rows,n", [
    (2, "f32", "sum", None, 8, 1000),
    (4, "f32", "max", None, 8, 1000),
    (8, "f32", "min", None, 8, 3001),
    (8, "f32", "sum", "evens", 8, 3001),
    (8, "f32", "max", "halves", 8, 2000),
    (4, "f32", "min", "pairs", 8, 999),
    (4, "f32", "sum", None, 256, MULTI),
    (2, "bf16", "sum", None, 16, 999),
    (4, "bf16", "max", None, 16, 2053),
    (8, "bf16", "min", "evens", 16, 3001),
    (8, "bf16", "sum", "halves", 16, 3001),
    (4, "bf16", "sum", "pairs", 256, MULTI),
])
def test_allreduce_plain_matches_pallas(nranks, dt, op, gname, tile_rows, n):
    data = spread((nranks, n), seed=n + nranks)
    jdt, tdt = DT[dt]
    size, groups = _size(nranks, gname), GROUPS[gname]
    want = _jax(lambda x: pallas_ring_allreduce(
        x, "world", size, tile_rows=tile_rows, interpret=True, groups=groups,
        op=op), data, jdt)
    got = to_numpy(ring.allreduce_world(world_from_numpy(data, "cpu", tdt),
                                        groups, op, tile_rows))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fold_order_is_not_a_plain_sum():
    """The reference's ring order differs from ``sum(0)`` at these
    magnitudes — the equality above is a real check of the order."""
    data = spread((8, 3001), seed=3)
    got = to_numpy(ring.allreduce_world(torch.from_numpy(data), None, "sum", 8))
    naive = torch.from_numpy(data).sum(0).numpy()
    assert not np.array_equal(_bits(got[0]), _bits(naive))


@pytest.mark.parametrize("nranks,dt,op,gname,tile_rows,block", [
    (2, "f32", "sum", None, 8, 300),
    (4, "f32", "max", None, 8, 1000),
    (8, "f32", "min", "halves", 8, 300),
    (8, "f32", "sum", "evens", 8, 129),
    (4, "f32", "sum", None, 256, 256 * 128 * 3 + 5),
    (4, "bf16", "sum", None, 16, 333),
    (8, "bf16", "max", "halves", 16, 200),
    (4, "bf16", "min", "pairs", 16, 77),
])
def test_reduce_scatter_plain_matches_pallas(nranks, dt, op, gname, tile_rows, block):
    size, groups = _size(nranks, gname), GROUPS[gname]
    data = spread((nranks, size, block), seed=block)
    jdt, tdt = DT[dt]
    want = _jax(lambda x: pallas_ring_reduce_scatter(
        x, "world", size, tile_rows=tile_rows, interpret=True, groups=groups,
        op=op), data, jdt)
    got = to_numpy(ring.reduce_scatter_world(world_from_numpy(data, "cpu", tdt),
                                             groups, op, tile_rows))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("nranks,dt,gname,tile_rows,block", [
    (2, "f32", None, 8, 77),
    (4, "f32", None, 8, 1000),
    (8, "f32", "evens", 8, 300),
    (4, "bf16", "pairs", 16, 333),
])
def test_allgather_plain_matches_pallas(nranks, dt, gname, tile_rows, block):
    size, groups = _size(nranks, gname), GROUPS[gname]
    data = spread((nranks, block), seed=block)
    jdt, tdt = DT[dt]
    want = _jax(lambda x: pallas_ring_allgather(
        x, "world", size, tile_rows=tile_rows, interpret=True, groups=groups),
        data, jdt)
    got = to_numpy(ring.allgather_world(world_from_numpy(data, "cpu", tdt),
                                        groups, tile_rows))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter", "allgather"])
def test_pallas_ring_via_communicators(mode):
    """``algorithm='pallas_ring'`` through both packages' runners, default
    tile_rows, split into interleaved groups."""
    import mpi_tpu_torch
    from mpi_tpu.tpu import TpuCommunicator, run_spmd
    from mpi_tpu_torch import TorchCommunicator

    groups = GROUPS["evens"]
    shape = (8, 4, 50) if mode == "reduce_scatter" else (8, 300)
    data = spread(shape, seed=11)
    jsub = TpuCommunicator("world", default_mesh()).split_by(lambda i: i % 2)
    tsub = TorchCommunicator.from_groups(groups)

    def jprog(comm, x):
        return getattr(jsub, mode)(x[comm.rank], algorithm="pallas_ring")

    def tprog(comm, x):
        return getattr(tsub, mode)(x[comm.rank], algorithm="pallas_ring")

    want = np.asarray(run_spmd(jprog, data, check_vma=False))
    ring.reset_launches()
    got = to_numpy(mpi_tpu_torch.run(tprog, data, nranks=8, device="cpu"))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert ring.LAUNCHES[mode] == 0  # the CPU takes the plain version


def test_diagnostics_match_reference():
    """The reference's diagnoses (test_pallas_ring.py:80,207)."""
    import mpi_tpu_torch
    from mpi_tpu_torch import ops

    with pytest.raises(NotImplementedError, match="built-in"):
        mpi_tpu_torch.run(lambda c: c.allreduce(torch.zeros(8), op=ops.PROD,
                                                algorithm="pallas_ring"),
                          nranks=8, device="cpu")
    with pytest.raises(NotImplementedError, match="float32/bfloat16"):
        ring.ring_allreduce(torch.zeros(8, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="leading dimension"):
        ring.ring_reduce_scatter(torch.zeros(7), 2)
    with pytest.raises(ValueError, match="tile_rows"):
        ring.allreduce_world(torch.zeros(2, 8), tile_rows=12)
    fake_max = ops.make_op(lambda a, b: a + b, name="max", identity=0.0)
    with pytest.raises(NotImplementedError, match="built-in"):
        mpi_tpu_torch.run(lambda c: c.allreduce(torch.zeros(8), op=fake_max,
                                                algorithm="pallas_ring"),
                          nranks=8, device="cpu")


def test_wrapper_launches_or_raises_off_cpu():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches the kernel (CUDA) or raises (here: the meta device)."""
    with pytest.raises(RuntimeError, match="CUDA"):
        ring.allreduce_world(torch.zeros(2, 8, device="meta"))


def test_per_rank_call_outside_run_raises():
    from mpi_tpu_torch import SpmdContextError

    with pytest.raises(SpmdContextError, match="run_spmd"):
        ring.ring_allreduce(torch.zeros(8), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter", "allgather"])
def test_kernel_matches_plain_on_card(mode):
    """CUDA kernel vs plain version, bitwise, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu on the card)")
    for dt in ("f32", "bf16"):
        for gname in (None, "halves"):
            for op in ("sum", "max", "min"):
                size = _size(8, gname)
                shape = (8, size, 1001) if mode == "reduce_scatter" else (8, 5001)
                x = world_from_numpy(spread(shape, 5), "cuda", DT[dt][1])
                if mode == "allreduce":
                    got = ring.allreduce_world(x, GROUPS[gname], op)
                    want = ring.allreduce_plain(x, GROUPS[gname], op)
                elif mode == "reduce_scatter":
                    got = ring.reduce_scatter_world(x, GROUPS[gname], op)
                    want = ring.reduce_scatter_plain(x, GROUPS[gname], op)
                else:
                    got = ring.allgather_world(x, GROUPS[gname])
                    want = ring.allgather_plain(x, GROUPS[gname])
                assert torch.equal(got, want), (dt, gname, op)
