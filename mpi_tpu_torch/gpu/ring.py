"""Ring collectives over the SPMD world: the CUDA kernel that replaces the
Pallas ring kernel, its plain PyTorch version, and the per-rank entry
points behind ``algorithm="pallas_ring"``.

Counterpart of ``mpi_tpu/tpu/pallas_ring.py``.  The TPU kernel (``_kernel``
:124, launched by ``_launch`` :434) runs a bidirectional pipelined RDMA
ring over chips.  On one card all P ranks' buffers share one memory, so
``csrc/ring.cu`` reads each group's inputs once, folds them in the TPU
ring's order and writes the outputs once (the design note is in the
source).  The chunk geometry (``_geometry``, ``_flows``, ``_segments``)
is copied from the reference because it decides that order: chunk ``a``
of a group of g ranks is folded starting at group position
``a - s*rot`` and walking in steps of ``s``, with ``s = +1`` for the
first ``tA = tiles - tiles//2`` tiles of a chunk and ``-1`` for the rest.

Three layers:

* ``allreduce_world`` / ``reduce_scatter_world`` / ``allgather_world`` take
  the physical ``[P, ...]`` world.  On a CUDA tensor they launch the kernel
  (and count the launch in ``LAUNCHES``) or raise; on a CPU tensor they run
  the plain version.
* ``allreduce_plain`` / ... are the plain versions: the TPU schedule
  step by step in torch ops (every device).
* ``ring_allreduce`` / ``ring_allgather`` / ``ring_reduce_scatter`` are the
  per-rank calls made inside ``run_spmd`` (the counterparts of
  ``pallas_ring_allreduce`` :526, ``pallas_ring_allgather`` :576 and
  ``pallas_ring_reduce_scatter`` :615); a custom op hands the world to the
  layer above.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import primitives

_LANES = 128
_SUBLANES = {torch.float32: 8, torch.bfloat16: 16}
_MAX_SEGMENTS = 4
_COMBINES = ("max", "min", "sum")
_OP_CODE = {"sum": 0, "max": 1, "min": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

Flow = Tuple[int, int, int]
Groups = Optional[Sequence[Sequence[int]]]

# kernel launches per mode: a wrapper adds one exactly where it launches
LAUNCHES: Dict[str, int] = {"allreduce": 0, "reduce_scatter": 0, "allgather": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- geometry: copies of mpi_tpu/tpu/pallas_ring.py:93-121, 312-317 ---------


def _segments(total_tiles: int) -> List[Tuple[int, int]]:
    """Split a chunk of ``total_tiles`` row-tiles into ≤_MAX_SEGMENTS
    contiguous (first_tile, num_tiles) pieces (pallas_ring.py:93)."""
    k = min(_MAX_SEGMENTS, total_tiles)
    base, extra = divmod(total_tiles, k)
    segs, t0 = [], 0
    for s in range(k):
        n = base + (1 if s < extra else 0)
        segs.append((t0, n))
        t0 += n
    return segs


def _flows(total_tiles: int, bidirectional: bool) -> List[Flow]:
    """Each chunk's row-tiles as (direction, first_tile, num_tiles) flows:
    the first ``tA`` tiles go right, the rest left (pallas_ring.py:106)."""
    tB = total_tiles // 2 if bidirectional else 0
    tA = total_tiles - tB
    flows: List[Flow] = [(+1, t0, nt) for (t0, nt) in _segments(tA)]
    if tB:
        flows += [(-1, tA + t0, nt) for (t0, nt) in _segments(tB)]
    return flows


def _geometry(n: int, size: int, tile_rows: int) -> Tuple[int, int]:
    """rows per chunk (multiple of tile_rows) and padded element count
    (pallas_ring.py:312)."""
    per_chunk = -(-n // size)
    rows = -(-per_chunk // _LANES)
    rows = -(-rows // tile_rows) * tile_rows
    return rows, size * rows * _LANES


def _right_tiles(rows: int, tile_rows: int, bidirectional: bool) -> int:
    tiles = rows // tile_rows
    return tiles - (tiles // 2 if bidirectional else 0)


# -- checks -------------------------------------------------------------------


def _check_args(dtype: torch.dtype, tile_rows: int, op: str) -> None:
    """The reference's diagnoses (pallas_ring.py:330)."""
    if dtype not in _SUBLANES:
        raise NotImplementedError(
            f"pallas_ring supports float32/bfloat16 for now, got {dtype}")
    if op not in _COMBINES:
        raise NotImplementedError(
            f"pallas_ring supports {sorted(_COMBINES)} for now, got {op!r}")
    sub = _SUBLANES[dtype]
    if tile_rows % sub or tile_rows < sub:
        raise ValueError(
            f"tile_rows must be a positive multiple of {sub} "
            f"({dtype} sublane tile), got {tile_rows}")


def _check_leading(shape, size: int) -> None:
    """pallas_ring.py:631."""
    if len(shape) == 0 or shape[0] != size:
        raise ValueError(
            f"reduce_scatter needs leading dimension == ring size {size} "
            f"(one block per rank), got shape {tuple(shape)}")


def _group_list(groups: Groups, nranks: int) -> List[List[int]]:
    if groups is None:
        return [list(range(nranks))]
    groups = [list(map(int, g)) for g in groups]
    if sorted(w for g in groups for w in g) != list(range(nranks)) or \
            len({len(g) for g in groups}) != 1:
        raise ValueError(
            f"groups must partition the {nranks} ranks into equal-sized "
            f"groups, got {groups}")
    return groups


def _check_world(world: torch.Tensor, groups: Groups, op: str,
                 tile_rows: int) -> List[List[int]]:
    _check_args(world.dtype, tile_rows, op)
    if world.dim() == 0:
        raise ValueError("a world tensor needs a leading rank dimension")
    if not world.is_contiguous():
        raise ValueError("ring kernels take a contiguous world tensor")
    return _group_list(groups, world.shape[0])


# -- plain version: the TPU schedule step by step ------------------------------


def _ring_tables(groups: List[List[int]], nranks: int, device):
    """Per world rank: group position, left and right ring neighbours
    (pallas_ring.py:411 ``_ring_params``)."""
    pos, left, right = [0] * nranks, [0] * nranks, [0] * nranks
    for g in groups:
        for p, w in enumerate(g):
            pos[w] = p
            left[w] = g[(p - 1) % len(g)]
            right[w] = g[(p + 1) % len(g)]
    as_t = lambda v: torch.as_tensor(v, dtype=torch.long, device=device)
    return as_t(pos), as_t(left), as_t(right)


def _run_schedule(grid: torch.Tensor, groups: List[List[int]], tile_rows: int,
                  bidirectional: bool, rot: int, op: str, rs: bool,
                  allgather: bool) -> None:
    """Run the TPU kernel's unified ring schedule (pallas_ring.py:157-299)
    on ``grid`` = ``[P, g, rows, 128]`` in place: every flow, every step,
    every rank at once.  At step u the sender of a flow forwards chunk
    ``send_chunk(u)``; in the reduce-scatter half the receiver folds it as
    ``own (+) received``, in the allgather half it stores it."""
    nranks, g, rows = grid.shape[0], grid.shape[1], grid.shape[2]
    pos, left, right = _ring_tables(groups, nranks, grid.device)
    ar = torch.arange(nranks, device=grid.device)
    combine = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op]
    n_rs = g - 1 if rs else 0
    n_steps = n_rs + (g - 1 if allgather else 0)
    flows = _flows(rows // tile_rows, bidirectional)
    for u in range(n_steps):
        for dirn, t0, nt in flows:
            sub = grid[:, :, t0 * tile_rows:(t0 + nt) * tile_rows]
            sender = left if dirn > 0 else right
            if dirn > 0:
                c = (pos[sender] - u + rot) % g
            else:
                c = (pos[sender] + u - rot) % g
            if u < n_rs:
                sub[ar, c] = combine(sub[ar, c], sub[sender, c])
            else:
                sub[ar, c] = sub[sender, c]


def allreduce_plain(world: torch.Tensor, groups: Groups = None, op: str = "sum",
                    tile_rows: int = 256, bidirectional: bool = True) -> torch.Tensor:
    """Plain version of the allreduce mode: ``[P, *shape]`` →
    ``[P, *shape]``, each rank holding its group's ring fold."""
    gl = _check_world(world, groups, op, tile_rows)
    nranks, shape, g = world.shape[0], world.shape[1:], len(gl[0])
    n = world[0].numel()
    rows, padded = _geometry(n, g, tile_rows)
    flat = torch.zeros((nranks, padded), dtype=world.dtype, device=world.device)
    flat[:, :n] = world.reshape(nranks, n)
    grid = flat.view(nranks, g, rows, _LANES)
    _run_schedule(grid, gl, tile_rows, bidirectional, rot=0, op=op, rs=True,
                  allgather=True)
    return flat[:, :n].reshape((nranks,) + tuple(shape))


def reduce_scatter_plain(world: torch.Tensor, groups: Groups = None,
                         op: str = "sum", tile_rows: int = 256,
                         bidirectional: bool = True) -> torch.Tensor:
    """Plain version of the reduce_scatter mode: ``[P, g, *block]`` →
    ``[P, *block]``, rank at group position b holding the fold of block b."""
    gl = _check_world(world, groups, op, tile_rows)
    nranks, g = world.shape[0], len(gl[0])
    _check_leading(world.shape[1:], g)
    block = world.shape[2:]
    block_n = world[0, 0].numel()
    rows, _ = _geometry(block_n * g, g, tile_rows)
    per_chunk = rows * _LANES
    flat = torch.zeros((nranks, g, per_chunk), dtype=world.dtype, device=world.device)
    flat[:, :, :block_n] = world.reshape(nranks, g, block_n)
    _run_schedule(flat.view(nranks, g, rows, _LANES), gl, tile_rows,
                  bidirectional, rot=-1, op=op, rs=True, allgather=False)
    pos, _, _ = _ring_tables(gl, nranks, world.device)
    mine = flat[torch.arange(nranks, device=world.device), pos]
    return mine[:, :block_n].reshape((nranks,) + tuple(block))


def allgather_plain(world: torch.Tensor, groups: Groups = None,
                    tile_rows: int = 256, bidirectional: bool = True) -> torch.Tensor:
    """Plain version of the allgather mode: ``[P, *block]`` →
    ``[P, g, *block]`` in group-rank order."""
    gl = _check_world(world, groups, "sum", tile_rows)
    nranks, block, g = world.shape[0], world.shape[1:], len(gl[0])
    block_n = world[0].numel()
    rows, _ = _geometry(block_n * g, g, tile_rows)
    per_chunk = rows * _LANES
    flat = torch.zeros((nranks, g, per_chunk), dtype=world.dtype, device=world.device)
    pos, _, _ = _ring_tables(gl, nranks, world.device)
    ar = torch.arange(nranks, device=world.device)
    flat[ar, pos, :block_n] = world.reshape(nranks, block_n)
    _run_schedule(flat.view(nranks, g, rows, _LANES), gl, tile_rows,
                  bidirectional, rot=0, op="sum", rs=False, allgather=True)
    return flat[:, :, :block_n].reshape((nranks, g) + tuple(block))


# -- the CUDA kernel -------------------------------------------------------------
#
# Each C entry point of csrc/ring.cu is a world-level ``torch.library`` op
# (``mpi_tpu_torch::ring_fold``, ``::ring_gather``): its CUDA
# implementation launches the kernel and counts the launch; its fake
# implementation only states the output, so a trace on fake CUDA tensors
# records the launch as one graph node and never builds or launches.

_TABLES: Dict[tuple, torch.Tensor] = {}


def _group_table(groups: List[List[int]], device) -> torch.Tensor:
    """The ``[ngroups, g]`` int32 group table on the device (cached)."""
    key = (str(device), tuple(map(tuple, groups)))
    t = _TABLES.get(key)
    if t is None:
        t = torch.tensor(groups, dtype=torch.int32, device=device)
        _TABLES[key] = t
    return t


def _vec(world: torch.Tensor, out: torch.Tensor, *lengths: int) -> int:
    """16-byte vectors when every row, chunk and pointer is aligned."""
    vec = 16 // world.element_size()
    aligned = world.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return vec if aligned and all(n % vec == 0 for n in lengths) else 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, mode: str) -> None:
    if err:
        raise RuntimeError(f"ring {mode} kernel launch failed: CUDA error {err}")


def _require_cuda(world: torch.Tensor) -> None:
    if world.device.type != "cuda":
        raise RuntimeError(
            f"ring kernels run on CUDA tensors (CPU tensors take the plain "
            f"version); got a tensor on {world.device}")


def _fold_shape(world: torch.Tensor, scatter: bool) -> Tuple[int, ...]:
    return (world.shape[0],) + tuple(world.shape[2:]) if scatter else tuple(world.shape)


@torch.library.custom_op("mpi_tpu_torch::ring_fold", mutates_args=(),
                         device_types="cuda")
def ring_fold(world: torch.Tensor, groups: List[int], size: int, op: str,
              tile_rows: int, bidirectional: bool, scatter: bool) -> torch.Tensor:
    """``ring_fold`` of csrc/ring.cu on a checked contiguous world: the
    allreduce (``scatter=False``, ``[P, *shape]`` out) or the
    reduce-scatter (``[P, g, *block]`` -> ``[P, *block]``) of each group of
    ``size`` consecutive entries of ``groups``."""
    from .. import _build

    gl = [list(groups[i:i + size]) for i in range(0, len(groups), size)]
    out = torch.empty(_fold_shape(world, scatter), dtype=world.dtype,
                      device=world.device)
    n_inner = world[0].numel()
    rows, _ = _geometry(n_inner, size, tile_rows)
    chunk_len = n_inner // size if scatter else rows * _LANES
    if n_inner == 0:
        return out
    mode = "reduce_scatter" if scatter else "allreduce"
    lib = _build.load("ring")
    table = _group_table(gl, world.device)
    vec = _vec(world, out, n_inner, chunk_len)
    with torch.cuda.device(world.device):
        err = lib.ring_fold(
            world.data_ptr(), out.data_ptr(), table.data_ptr(), len(gl), size,
            n_inner, chunk_len, tile_rows * _LANES,
            _right_tiles(rows, tile_rows, bidirectional), -1 if scatter else 0,
            int(scatter), _DTYPE_CODE[world.dtype], _OP_CODE[op], vec,
            _stream(world))
    _raise_on(err, mode)
    LAUNCHES[mode] += 1
    return out


@ring_fold.register_fake
def _(world, groups, size, op, tile_rows, bidirectional, scatter):
    return world.new_empty(_fold_shape(world, scatter))


@torch.library.custom_op("mpi_tpu_torch::ring_gather", mutates_args=(),
                         device_types="cuda")
def ring_gather(world: torch.Tensor, groups: List[int], size: int) -> torch.Tensor:
    """``ring_gather`` of csrc/ring.cu: ``[P, *block]`` -> ``[P, g, *block]``."""
    from .. import _build

    gl = [list(groups[i:i + size]) for i in range(0, len(groups), size)]
    out = torch.empty((world.shape[0], size) + tuple(world.shape[1:]),
                      dtype=world.dtype, device=world.device)
    block_n = world[0].numel()
    if block_n == 0:
        return out
    lib = _build.load("ring")
    table = _group_table(gl, world.device)
    vec = _vec(world, out, block_n)
    with torch.cuda.device(world.device):
        err = lib.ring_gather(world.data_ptr(), out.data_ptr(), table.data_ptr(),
                              len(gl), size, block_n, _DTYPE_CODE[world.dtype],
                              vec, _stream(world))
    _raise_on(err, "allgather")
    LAUNCHES["allgather"] += 1
    return out


@ring_gather.register_fake
def _(world, groups, size):
    return world.new_empty((world.shape[0], size) + tuple(world.shape[1:]))


def _flat(gl: List[List[int]]) -> List[int]:
    return [w for g in gl for w in g]


def allreduce_world(world: torch.Tensor, groups: Groups = None, op: str = "sum",
                    tile_rows: int = 256, bidirectional: bool = True) -> torch.Tensor:
    """Allreduce mode over a ``[P, *shape]`` world: the kernel on CUDA, the
    plain version on the CPU."""
    if world.device.type == "cpu":
        return allreduce_plain(world, groups, op, tile_rows, bidirectional)
    _require_cuda(world)
    gl = _check_world(world, groups, op, tile_rows)
    return ring_fold(world, _flat(gl), len(gl[0]), op, tile_rows,
                     bidirectional, False)


def reduce_scatter_world(world: torch.Tensor, groups: Groups = None,
                         op: str = "sum", tile_rows: int = 256,
                         bidirectional: bool = True) -> torch.Tensor:
    """Reduce-scatter mode over a ``[P, g, *block]`` world."""
    if world.device.type == "cpu":
        return reduce_scatter_plain(world, groups, op, tile_rows, bidirectional)
    _require_cuda(world)
    gl = _check_world(world, groups, op, tile_rows)
    _check_leading(world.shape[1:], len(gl[0]))
    return ring_fold(world, _flat(gl), len(gl[0]), op, tile_rows,
                     bidirectional, True)


def allgather_world(world: torch.Tensor, groups: Groups = None,
                    tile_rows: int = 256, bidirectional: bool = True) -> torch.Tensor:
    """Allgather mode over a ``[P, *block]`` world → ``[P, g, *block]``."""
    if world.device.type == "cpu":
        return allgather_plain(world, groups, tile_rows, bidirectional)
    _require_cuda(world)
    gl = _check_world(world, groups, "sum", tile_rows)
    return ring_gather(world, _flat(gl), len(gl[0]))


# -- per-rank entry points (inside run_spmd) -----------------------------------


@torch.library.custom_op("mpi_tpu_torch::ring", mutates_args=())
def _ring(x: torch.Tensor, rank: torch.Tensor, groups: List[int], size: int,
          mode: str, op: str, tile_rows: int, bidirectional: bool) -> torch.Tensor:
    raise primitives._outside(f"ring_{mode}")


def _ring_vmap(info, in_dims, x, rank, groups, size, mode, op, tile_rows,
               bidirectional):
    world = primitives.as_world(x, in_dims[0], info.batch_size)
    gl = [list(groups[i:i + size]) for i in range(0, len(groups), size)]
    if mode == "allreduce":
        return allreduce_world(world, gl, op, tile_rows, bidirectional), 0
    if mode == "reduce_scatter":
        return reduce_scatter_world(world, gl, op, tile_rows, bidirectional), 0
    return allgather_world(world, gl, tile_rows, bidirectional), 0


_ring.register_vmap(_ring_vmap)


def _call(x: torch.Tensor, size: int, groups: Groups, mode: str, op: str,
          tile_rows: int, bidirectional: bool) -> torch.Tensor:
    w = primitives.current(f"ring_{mode}")
    gl = _group_list(groups, w.nranks)
    if len(gl[0]) != size:
        raise ValueError(f"ring size {size} != group size {len(gl[0])}")
    flat = [r for g in gl for r in g]
    return _ring(primitives.as_tensor(x), w.idx, flat, size, mode, op,
                 tile_rows, bidirectional)


def ring_allreduce(x: torch.Tensor, size: int, tile_rows: int = 256,
                   bidirectional: bool = True, groups: Groups = None,
                   op: str = "sum") -> torch.Tensor:
    """Allreduce ``x`` (f32/bf16; ``op`` in sum/max/min) over the ring of
    this rank's group of ``size`` ranks (``groups=None``: the whole
    world).  Call inside ``run_spmd``."""
    _check_args(x.dtype, tile_rows, op)
    if size == 1:
        return x
    return _call(x, size, groups, "allreduce", op, tile_rows, bidirectional)


def ring_allgather(x: torch.Tensor, size: int, tile_rows: int = 256,
                   bidirectional: bool = True, groups: Groups = None) -> torch.Tensor:
    """Every rank contributes block ``x``; returns ``[size, *x.shape]`` in
    group-rank order."""
    _check_args(x.dtype, tile_rows, "sum")
    if size == 1:
        return x[None]
    return _call(x, size, groups, "allgather", "sum", tile_rows, bidirectional)


def ring_reduce_scatter(x: torch.Tensor, size: int, tile_rows: int = 256,
                        bidirectional: bool = True, groups: Groups = None,
                        op: str = "sum") -> torch.Tensor:
    """``x`` is the ``[size, *block]`` stack on every rank; group rank r
    returns block r reduced over the group."""
    _check_leading(x.shape, size)
    _check_args(x.dtype, tile_rows, op)
    if size == 1:
        return x[0]
    return _call(x, size, groups, "reduce_scatter", op, tile_rows, bidirectional)
