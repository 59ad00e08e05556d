"""Derived datatypes — MPI-1 chapter-3 layout descriptors [S].

Own copy of ``mpi_tpu/datatypes.py``: the constructors, the numpy host path
(``pack``/``unpack``, ``MPI_Pack``/``MPI_Unpack``, external32) unchanged,
and the device path ``pack_jax``/``unpack_jax`` (:185-248) as
``pack_torch``/``unpack_torch``.  A committed datatype is a flat *gather
index vector* over the base-typed buffer, and then

* ``pack``   = ``buf.flat[idx]``        (numpy take / one ``index_select``)
* ``unpack`` = ``out.flat[idx] = data``  (numpy scatter / an out-of-place
  ``index_put``)

so the same index map drives host code and the SPMD program (the indices
are static, computed on the host when the program is traced by the rank
vmap).  Byte-based maps view the tensor as ``torch.uint8``.  The torch
path's dtype check is exact (see ``_check_torch_dtype``).

Units and composition follow MPI semantics: displacements/strides in the
element constructors are in units of the *base type's extent*; heterogeneous
``type_create_struct`` drops to a byte-based map (base dtype uint8, byte
displacements), which is also what lets numpy structured dtypes interoperate.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

__all__ = [
    "Datatype", "type_contiguous", "type_vector", "type_indexed",
    "type_create_subarray", "type_create_struct", "type_create_resized",
    "type_create_hvector", "type_create_hindexed",
    "from_structured", "pack", "unpack", "pack_size",
    "pack_external", "unpack_external",
]

BaseLike = Union[str, type, np.dtype, "Datatype"]

# the torch dtype of each numpy base type the torch path takes
_TORCH_DTYPES = {np.dtype(t): torch.from_numpy(np.zeros(0, t)).dtype for t in (
    np.bool_, np.uint8, np.uint16, np.uint32, np.uint64, np.int8, np.int16,
    np.int32, np.int64, np.float16, np.float32, np.float64, np.complex64,
    np.complex128)}


def _as_base(base: BaseLike) -> "Datatype":
    if isinstance(base, Datatype):
        return base
    dt = np.dtype(base)
    if dt.names:  # structured dtype: byte-based map over its fields
        return from_structured(dt)
    if dt == np.uint8:  # MPI_BYTE: endian-neutral, external32 identity
        return Datatype(dt, np.arange(1, dtype=np.int64), 1,
                        elem_sizes=np.ones(1, np.int64))
    return Datatype(dt, np.arange(1, dtype=np.int64), 1)


class Datatype:
    """A committed layout: ``indices`` are element offsets (units of
    ``base_dtype``) selected by one instance; ``extent`` is the span one
    instance occupies when instances are replicated (``count > 1`` or an
    outer constructor), mirroring MPI extent semantics [S]."""

    __slots__ = ("base_dtype", "indices", "extent", "lb", "elem_sizes",
                 "_committed")

    def __init__(self, base_dtype: np.dtype, indices: np.ndarray, extent: int,
                 lb: int = 0, elem_sizes: Optional[np.ndarray] = None):
        self.base_dtype = np.dtype(base_dtype)
        self.indices = np.asarray(indices, dtype=np.int64).reshape(-1)
        self.extent = int(extent)
        self.lb = int(lb)  # bookkeeping only (get_extent); never shifts the map
        # byte-based (struct) maps only: per-ELEMENT byte lengths of one
        # packed instance, in packed order — what external32 needs to
        # byteswap field-wise (a whole-stream swap would be a no-op on
        # uint8).  None ⇔ not a struct map / unknown (external32 refuses).
        self.elem_sizes = (None if elem_sizes is None
                           else np.asarray(elem_sizes, dtype=np.int64))
        self._committed = False

    # -- introspection (MPI_Type_size / MPI_Type_get_extent) ---------------

    @property
    def size(self) -> int:
        """Bytes of actual data one instance transfers (MPI_Type_size)."""
        return int(self.indices.size * self.base_dtype.itemsize)

    @property
    def count(self) -> int:
        """Base elements one instance transfers."""
        return int(self.indices.size)

    @property
    def extent_bytes(self) -> int:
        return self.extent * self.base_dtype.itemsize

    def commit(self) -> "Datatype":
        """MPI_Type_commit: validate the map (duplicate offsets would make
        unpack order-dependent; negatives would alias from the end)."""
        if self.indices.size and int(self.indices.min()) < 0:
            raise ValueError("datatype has negative element displacements")
        if np.unique(self.indices).size != self.indices.size:
            raise ValueError("datatype maps the same element twice "
                             "(overlapping blocks) — unpack would be "
                             "order-dependent")
        self._committed = True
        return self

    def free(self) -> None:
        """MPI_Type_free (bookkeeping only — no resources to release)."""
        self._committed = False

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"Datatype(base={self.base_dtype}, count={self.count}, "
                f"extent={self.extent})")

    # -- replication helper ------------------------------------------------

    def _tiled(self, count: int) -> np.ndarray:
        if count == 1:
            return self.indices
        offs = np.arange(count, dtype=np.int64) * self.extent
        return (self.indices[None, :] + offs[:, None]).reshape(-1)

    def _flat_view(self, buf: Any, writeback: bool = False) -> np.ndarray:
        if writeback and not isinstance(buf, np.ndarray):
            raise TypeError(f"unpack target must be an ndarray, got "
                            f"{type(buf).__name__}")
        a = np.asarray(buf)
        if writeback and not a.flags["C_CONTIGUOUS"]:
            # ascontiguousarray would copy and the scatter would land in
            # the copy — a silent no-op on the caller's buffer
            raise TypeError("unpack target must be C-contiguous (got a "
                            "strided view; unpack into the owning array "
                            "and describe the view with the datatype)")
        a = np.ascontiguousarray(a)
        if self.base_dtype == np.uint8 and a.dtype != np.uint8:
            a = a.view(np.uint8)
        elif a.dtype != self.base_dtype:
            raise TypeError(f"buffer dtype {a.dtype} != datatype base "
                            f"{self.base_dtype}")
        return a.reshape(-1)

    def _checked_indices(self, count: int, limit: int,
                         writeback: bool = False) -> np.ndarray:
        idx = self._tiled(count)
        if idx.size and int(idx.min()) < 0:
            raise ValueError("datatype has negative element displacements")
        if idx.size and int(idx.max()) >= limit:
            raise ValueError(f"datatype touches element {int(idx.max())} but "
                             f"buffer has {limit}")
        if writeback and count > 1 and self.indices.size and \
                self.extent <= int(self.indices.max()):
            # RECEIVE side only: MPI permits overlapping send typemaps
            # (reading an element twice is well-defined); an overlapping
            # unpack would be order-dependent.  Instances can interleave
            # only when the extent is inside the map's span — only then
            # pay for the uniqueness check.
            if np.unique(idx).size != idx.size:
                raise ValueError(
                    f"replicating {count} instances at extent {self.extent} "
                    "maps the same element twice (instances overlap) — "
                    "unpack would be order-dependent")
        return idx

    # -- host (numpy) path -------------------------------------------------

    def pack(self, buf: Any, count: int = 1) -> np.ndarray:
        """Gather ``count`` instances from ``buf`` into a contiguous array."""
        flat = self._flat_view(buf)
        idx = self._checked_indices(count, flat.size)
        return flat[idx].copy()

    def unpack(self, packed: Any, out: np.ndarray, count: int = 1) -> np.ndarray:
        """Scatter a contiguous ``packed`` array into ``out`` in-place."""
        flat = self._flat_view(out, writeback=True)
        idx = self._checked_indices(count, flat.size, writeback=True)
        data = np.asarray(packed).reshape(-1)
        if data.dtype != self.base_dtype:
            raise TypeError(f"packed payload dtype {data.dtype} != datatype "
                            f"base {self.base_dtype}")
        if data.size != idx.size:
            raise ValueError(f"packed payload has {data.size} elements, "
                             f"datatype expects {idx.size}")
        flat[idx] = data
        return out

    # -- device (torch) path --------------------------------------------

    def _torch_dtype(self):
        # a table, not ``torch.from_numpy(np.zeros(0, dt)).dtype``: under a
        # trace that empty tensor would be lifted into the graph as a
        # constant with no storage, which ``torch.export.save`` cannot write
        dt = np.dtype(self.base_dtype)
        if dt not in _TORCH_DTYPES:
            raise TypeError(f"datatype base {dt} has no torch dtype; the torch "
                            f"path takes {sorted(str(d) for d in _TORCH_DTYPES)}")
        return _TORCH_DTYPES[dt]

    @staticmethod
    def _byte_view(x: torch.Tensor) -> torch.Tensor:
        """Byte-based maps index BYTES: reinterpret the buffer as a uint8
        stream (the torch spelling of _flat_view's ``a.view(np.uint8)``)."""
        flat = x.reshape(-1)
        return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)

    def pack_torch(self, x: Any, count: int = 1) -> torch.Tensor:
        """The gather on a tensor: one ``index_select`` with the static
        index map (valid inside the rank vmap of ``run_spmd``)."""
        x = torch.as_tensor(x)
        self._check_torch_dtype(x)
        flat = self._byte_view(x) if self.base_dtype == np.uint8 else x.reshape(-1)
        idx = self._checked_indices(count, flat.numel())
        return torch.index_select(flat, 0, torch.as_tensor(idx, device=flat.device))

    def unpack_torch(self, packed: Any, out: Any, count: int = 1) -> torch.Tensor:
        """Functional scatter: returns ``out`` with the instances placed,
        an out-of-place ``index_put`` on the flat buffer (``out`` may be a
        tensor made inside the rank vmap, which a batched payload cannot be
        written into in place)."""
        o = torch.as_tensor(out)
        self._check_torch_dtype(o)
        data = torch.as_tensor(packed, device=o.device).reshape(-1)
        flat = self._byte_view(o) if self.base_dtype == np.uint8 else o.reshape(-1)
        # same strictness as the host path: exact payload dtype and size
        if data.dtype != flat.dtype:
            raise TypeError(f"packed payload dtype {data.dtype} != datatype "
                            f"base {flat.dtype}")
        idx = self._checked_indices(count, flat.numel(), writeback=True)
        if data.numel() != idx.size:
            raise ValueError(f"packed payload has {data.numel()} elements, "
                             f"datatype expects {idx.size}")
        flat = flat.index_put((torch.as_tensor(idx, device=flat.device),), data)
        if self.base_dtype == np.uint8 and o.dtype != torch.uint8:
            flat = flat.view(o.dtype)
        return flat.reshape(o.shape)

    def _check_torch_dtype(self, x: torch.Tensor) -> None:
        """Same strictness as the numpy path — indices are ELEMENT offsets,
        so a buffer of a different dtype would be a silent reinterpretation.
        The check is exact, where the reference's ``_check_jax_dtype``
        (:235) compares with JAX's canonicalized base dtype and so lets a
        float32 buffer through for a float64 map (x64 off): torch has no
        such narrowing, and a float64 map takes float64 tensors only.
        Byte-based maps are exempt, as on the host path."""
        if self.base_dtype == np.uint8:
            return
        if x.dtype != self._torch_dtype():
            raise TypeError(f"buffer dtype {x.dtype} != datatype base "
                            f"{self.base_dtype}")


# -- constructors (MPI_Type_*) ---------------------------------------------


def _tile_es(b: "Datatype", n: int) -> Optional[np.ndarray]:
    """Replicate a byte-based base's per-element sizes through a derived
    constructor (element order is preserved by every constructor)."""
    if b.base_dtype != np.uint8 or b.elem_sizes is None:
        return None
    return np.tile(b.elem_sizes, n)


def type_contiguous(count: int, base: BaseLike) -> Datatype:
    """MPI_Type_contiguous: ``count`` back-to-back instances of ``base``."""
    b = _as_base(base)
    return Datatype(b.base_dtype, b._tiled(int(count)), int(count) * b.extent,
                    elem_sizes=_tile_es(b, int(count)))


def type_vector(count: int, blocklength: int, stride: int,
                base: BaseLike) -> Datatype:
    """MPI_Type_vector: ``count`` blocks of ``blocklength`` instances,
    block starts ``stride`` base-extents apart (a strided matrix column:
    ``type_vector(nrows, 1, ncols, float64)``)."""
    b = _as_base(base)
    count, blocklength, stride = int(count), int(blocklength), int(stride)
    starts = np.arange(count, dtype=np.int64) * stride * b.extent
    block = b._tiled(blocklength)
    idx = (starts[:, None] + block[None, :]).reshape(-1)
    extent = ((count - 1) * stride + blocklength) * b.extent if count else 0
    return Datatype(b.base_dtype, idx, extent,
                    elem_sizes=_tile_es(b, count * blocklength))


def type_indexed(blocklengths: Sequence[int], displacements: Sequence[int],
                 base: BaseLike) -> Datatype:
    """MPI_Type_indexed: irregular blocks at arbitrary displacements
    (units of the base extent)."""
    b = _as_base(base)
    if len(blocklengths) != len(displacements):
        raise ValueError("blocklengths and displacements differ in length")
    parts = []
    span = 0
    for n, d in zip(blocklengths, displacements):
        n, d = int(n), int(d)
        parts.append(d * b.extent + b._tiled(n))
        span = max(span, (d + n) * b.extent)
    idx = np.concatenate(parts) if parts else np.empty(0, np.int64)
    total = sum(int(n) for n in blocklengths)
    return Datatype(b.base_dtype, idx, span, elem_sizes=_tile_es(b, total))


def type_create_subarray(sizes: Sequence[int], subsizes: Sequence[int],
                         starts: Sequence[int], base: BaseLike) -> Datatype:
    """MPI_Type_create_subarray (C order): the n-D sub-block
    ``[start : start+subsize]`` per dim of an n-D array — THE datatype for
    halo faces and tiled I/O.  Extent spans the whole array, so ``count``
    instances mean consecutive whole arrays (matching MPI)."""
    b = _as_base(base)
    sizes = [int(s) for s in sizes]
    subsizes = [int(s) for s in subsizes]
    starts = [int(s) for s in starts]
    if not (len(sizes) == len(subsizes) == len(starts)):
        raise ValueError("sizes/subsizes/starts rank mismatch")
    for s, sub, st in zip(sizes, subsizes, starts):
        if st < 0 or sub < 0 or st + sub > s:
            raise ValueError(f"subarray [{st}:{st + sub}] out of bounds "
                             f"for size {s}")
    # element offsets of the sub-block in the row-major full array
    grid = np.ix_(*[np.arange(st, st + sub) for st, sub in zip(starts, subsizes)])
    flat_idx = np.ravel_multi_index(np.broadcast_arrays(*grid), sizes)
    idx = np.asarray(flat_idx, dtype=np.int64).reshape(-1)
    n_elems = int(np.prod(sizes)) if sizes else 1
    # compose with a non-trivial base by expanding each element slot
    n_sel = idx.size
    if b.count != 1 or b.extent != 1:
        idx = (idx[:, None] * b.extent + b.indices[None, :]).reshape(-1)
        n_elems *= b.extent
    return Datatype(b.base_dtype, idx, n_elems,
                    elem_sizes=_tile_es(b, n_sel))


def type_create_struct(blocklengths: Sequence[int],
                       displacements: Sequence[int],
                       types: Sequence[BaseLike]) -> Datatype:
    """MPI_Type_create_struct: heterogeneous blocks at *byte* displacements.
    Compiles to a byte-based map (base uint8) — the contiguous packed form
    is raw bytes, interoperable with numpy structured dtypes."""
    if not (len(blocklengths) == len(displacements) == len(types)):
        raise ValueError("struct constructor argument lengths differ")
    parts = []
    sizes = []  # per-element byte lengths, packed order (for external32)
    span = 0
    for n, d, t in zip(blocklengths, displacements, types):
        b = _as_base(t)
        n, d = int(n), int(d)
        item = b._tiled(n) * b.base_dtype.itemsize  # element→byte offsets
        byte_idx = (item[:, None]
                    + np.arange(b.base_dtype.itemsize, dtype=np.int64)[None, :]
                    ).reshape(-1) + d
        parts.append(byte_idx)
        if b.base_dtype == np.uint8:
            sizes.append(None if b.elem_sizes is None
                         else np.tile(b.elem_sizes, n))
        elif b.base_dtype.kind == "c":
            # complex = two independently-endian components: swapping the
            # whole element would also swap real/imag order on the wire
            sizes.append(np.full(n * b.count * 2,
                                 b.base_dtype.itemsize // 2, np.int64))
        else:
            sizes.append(np.full(n * b.count, b.base_dtype.itemsize,
                                 np.int64))
        span = max(span, d + n * b.extent_bytes)
    idx = np.concatenate(parts) if parts else np.empty(0, np.int64)
    es = (np.concatenate(sizes) if sizes and all(s is not None for s in sizes)
          else None)
    return Datatype(np.dtype(np.uint8), idx, span, elem_sizes=es)


def type_create_hvector(count: int, blocklength: int, stride_bytes: int,
                        base: BaseLike) -> Datatype:
    """MPI_Type_create_hvector: like type_vector but the stride is in
    BYTES.  The index-map model addresses typed elements, so the byte
    stride must be a whole multiple of the base extent (arbitrary byte
    strides would mis-align every element); misuse is diagnosed, not
    approximated."""
    b = _as_base(base)
    unit = b.extent_bytes  # type_vector strides are in units of the base
    # EXTENT (a derived base spans extent elements, not one itemsize)
    if unit == 0 or stride_bytes % unit:
        raise ValueError(
            f"hvector byte stride {stride_bytes} is not a multiple of the "
            f"base extent {unit} bytes — such a layout cannot address "
            f"whole base instances (use a uint8-based struct map for raw "
            f"bytes)")
    return type_vector(count, blocklength, stride_bytes // unit, base)


def type_create_hindexed(blocklengths: Sequence[int],
                         byte_displacements: Sequence[int],
                         base: BaseLike) -> Datatype:
    """MPI_Type_create_hindexed: indexed with BYTE displacements (same
    whole-element restriction as hvector)."""
    b = _as_base(base)
    unit = b.extent_bytes  # displacements are in base-EXTENT units too
    disps = []
    for d in byte_displacements:
        if unit == 0 or int(d) % unit:
            raise ValueError(
                f"hindexed byte displacement {d} is not a multiple of the "
                f"base extent {unit} bytes")
        disps.append(int(d) // unit)
    return type_indexed(blocklengths, disps, base)


def type_create_resized(base: BaseLike, lb: int, extent: int) -> Datatype:
    """MPI_Type_create_resized: same typemap (displacements UNCHANGED —
    lb/extent are bookkeeping markers in MPI, not shifts [S]); ``extent``
    (units of the base dtype) controls where replicated instances land;
    ``lb`` is recorded for MPI_Type_get_extent."""
    b = _as_base(base)
    return Datatype(b.base_dtype, b.indices, int(extent), lb=int(lb),
                    elem_sizes=b.elem_sizes)


def from_structured(dtype: Any) -> Datatype:
    """A numpy structured dtype as a (byte-based) MPI struct — including
    its padding holes, which are skipped exactly like MPI_UB gaps."""
    dt = np.dtype(dtype)
    if not dt.names:
        raise ValueError(f"{dt} is not a structured dtype")
    lens, disps, types = [], [], []
    for name in dt.names:
        fdt, off = dt.fields[name][0], dt.fields[name][1]
        if fdt.subdtype is not None:
            sub, shape = fdt.subdtype
            lens.append(int(np.prod(shape)))
            types.append(sub)
        else:
            lens.append(1)
            types.append(fdt)
        disps.append(off)
    out = type_create_struct(lens, disps, types)
    return Datatype(out.base_dtype, out.indices, dt.itemsize,
                    elem_sizes=out.elem_sizes)


# -- MPI_Pack / MPI_Unpack --------------------------------------------------


def pack(buf: Any, datatype: Datatype, count: int = 1,
         position: Optional[bytearray] = None) -> bytes:
    """MPI_Pack: append ``count`` instances to ``position`` (a growing
    bytearray standing in for the MPI position cursor) and return the
    packed bytes added."""
    data = datatype.pack(buf, count).tobytes()
    if position is not None:
        position.extend(data)
    return data


def unpack(packed: Union[bytes, bytearray, memoryview], datatype: Datatype,
           out: np.ndarray, count: int = 1, offset: int = 0) -> int:
    """MPI_Unpack: consume ``count`` instances from ``packed`` starting at
    byte ``offset`` into ``out``; returns the new offset."""
    nbytes = datatype.size * count
    chunk = np.frombuffer(bytes(packed[offset:offset + nbytes]),
                          dtype=datatype.base_dtype)
    datatype.unpack(chunk, out, count)
    return offset + nbytes


def pack_size(count: int, datatype: Datatype) -> int:
    """MPI_Pack_size: bytes needed for ``count`` instances."""
    return datatype.size * int(count)


# -- external32 (MPI_Pack_external [S]) -------------------------------------


def _swap_struct_bytes(raw: np.ndarray, datatype: Datatype,
                       count: int) -> np.ndarray:
    """Reverse each element's byte run in a packed struct stream (the
    field-wise endianness flip; a whole-stream swap is a no-op on uint8)."""
    if datatype.elem_sizes is None:
        raise NotImplementedError(
            "external32 needs per-element sizes, which this byte-based "
            "datatype does not carry (composed byte maps); pack the "
            "fields with elementary/struct datatypes instead")
    import sys

    if sys.byteorder == "big":  # memory order already IS external32
        return raw
    sizes = np.tile(datatype.elem_sizes, count)
    uniq = np.unique(sizes)
    if uniq.size == 1:
        s = int(uniq[0])
        if s <= 1:
            return raw
        return np.ascontiguousarray(raw.reshape(-1, s)[:, ::-1]).reshape(-1)
    # mixed field sizes: reverse runs of equal size in vectorized groups
    out = raw.copy()
    bounds = np.concatenate(([0], np.cumsum(sizes)))
    pos = 0
    while pos < sizes.size:
        s = int(sizes[pos])
        end = pos
        while end < sizes.size and sizes[end] == s:
            end += 1
        if s > 1:
            b0, b1 = int(bounds[pos]), int(bounds[end])
            out[b0:b1] = np.ascontiguousarray(
                out[b0:b1].reshape(-1, s)[:, ::-1]).reshape(-1)
        pos = end
    return out


def pack_external(buf: Any, datatype: Datatype, count: int = 1) -> bytes:
    """MPI_Pack_external("external32"): the portable big-endian wire
    format — same gather as :func:`pack`, bytes emitted big-endian so
    heterogeneous receivers agree.  Struct (byte-based) maps byteswap
    FIELD-WISE via the per-element sizes recorded at construction."""
    data = datatype.pack(buf, count)
    if datatype.base_dtype == np.uint8:
        return _swap_struct_bytes(data, datatype, count).tobytes()
    return data.astype(data.dtype.newbyteorder(">"), copy=False).tobytes()


def unpack_external(packed: Any, datatype: Datatype, out: np.ndarray,
                    count: int = 1, offset: int = 0) -> int:
    """MPI_Unpack_external: consume big-endian instances; returns the new
    byte offset."""
    nbytes = datatype.size * count
    chunk = bytes(packed[offset:offset + nbytes])
    if datatype.base_dtype == np.uint8:
        host = _swap_struct_bytes(np.frombuffer(chunk, np.uint8),
                                  datatype, count)
        datatype.unpack(host, out, count)
        return offset + nbytes
    be = np.frombuffer(chunk, dtype=datatype.base_dtype.newbyteorder(">"))
    datatype.unpack(be.astype(datatype.base_dtype), out, count)
    return offset + nbytes
