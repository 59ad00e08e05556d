"""MPI-IO — parallel file I/O (MPI-2 ch.9 [S]); the port's own copy of
``mpi_tpu/io.py`` (:1-695).

* **Explicit offsets** (``read_at`` / ``write_at``) are independent
  ``pread`` / ``pwrite`` on a per-rank fd; offsets are in *etype* units
  within the current **file view**.
* **File views** (``set_view``) reuse the port's ``datatypes.py``: the
  filetype's committed index map IS the view — visible element ``i`` lands
  at file element ``indices[i % k] + (i // k) * extent`` (k = map size),
  and runs of consecutive file bytes are coalesced before they reach the
  OS (``_byte_runs``, :377), so a strided view costs one syscall per
  contiguous run, not per element.
* **Individual file pointers** (``seek`` / ``read`` / ``write``) are plain
  per-rank state.
* **Shared file pointers** (``read_shared`` / ``write_shared``) are a
  fetch-and-add on a passive-target window at rank 0 (``window.py``
  ``P2PWindow``; :498-541).
* **Collective I/O**: ``write_at_all`` is two-phase collective buffering
  below ``_COLLECTIVE_BUFFER_LIMIT`` (8 MiB, :65, :583) — ranks ship their
  (byte run, bytes) lists to rank 0, which applies them as one sorted
  sweep — and independent writes inside the same barrier bracket above
  it; the branch is decided collectively (the allreduced total against
  rank 0's limit).  ``read_at_all`` is a barrier-bracketed independent
  read.
* **Data representations**: ``native``, ``external32`` (big-endian) and
  ``register_datarep`` (:228), whose callbacks keep the reference's bytes
  contract on the host: ``read_fn(raw: bytes, etype: np.dtype, count,
  extra[, position]) -> ndarray``, ``write_fn(arr: ndarray, etype, extra
  [, position]) -> bytes``.

Tensors: a write takes a tensor on any device, an ndarray or anything
``np.asarray`` takes; a card tensor is staged to pinned host memory ONCE
per call (``_stage``), never once per byte run.  A read returns a tensor
on the communicator's device: a card read lands in pinned host memory and
is copied over once.  The bytes on disk are the reference's: a file
either package wrote reads bitwise in the other.  The access modes and
seek origins keep the reference's values (:51-59).

Process backends only (the fd and the window server live on ranks); for
sharded card state use ``mpi_tpu_torch.checkpoint``.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .communicator import Communicator, P2PCommunicator
from .datatypes import Datatype

__all__ = [
    "File", "file_open", "file_delete", "register_datarep", "Datarep",
    "MODE_RDONLY", "MODE_WRONLY", "MODE_RDWR", "MODE_CREATE", "MODE_EXCL",
    "MODE_APPEND", "MODE_DELETE_ON_CLOSE",
    "SEEK_SET", "SEEK_CUR", "SEEK_END",
]

MODE_RDONLY = 1
MODE_WRONLY = 2
MODE_RDWR = 4
MODE_CREATE = 8
MODE_EXCL = 16
MODE_APPEND = 32
MODE_DELETE_ON_CLOSE = 64

SEEK_SET, SEEK_CUR, SEEK_END = 0, 1, 2

_TAG_TWOPHASE = -30  # internal tag (negative: invisible to user wildcards)

# write_at_all ships runs to the aggregator only below this total; above
# it, shipping costs more than it saves and ranks write directly
_COLLECTIVE_BUFFER_LIMIT = 8 << 20


# -- data representations (MPI_Register_datarep, MPI-2 §9.5 [S]) ------------


def _wants_position(fn, base_params: int) -> str:
    """How a datarep callback takes the optional ``position`` argument
    (``mpi_tpu/io.py:71``): ``"pos"`` (a trailing positional parameter
    NAMED ``position``, or ``*args``), ``"kw"`` (a keyword-only
    ``position``), or ``""`` (position-free, also for callables hiding
    their signature).  A trailing parameter with another name gets a
    warning: a required one still receives the position, a defaulted one
    keeps its default."""
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return ""
    params = list(sig.parameters.values())
    kinds = [p.kind for p in params]
    if any(p.kind == inspect.Parameter.KEYWORD_ONLY
           and p.name == "position" for p in params):
        return "kw"
    if inspect.Parameter.VAR_POSITIONAL in kinds:
        return "pos"
    positional = [p for p in params
                  if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    if len(positional) <= base_params:
        return ""
    extra = positional[base_params]
    if extra.name == "position":
        return "pos"
    import warnings

    if extra.default is inspect.Parameter.empty:
        warnings.warn(
            f"datarep callback {getattr(fn, '__name__', fn)!r} takes the "
            f"element position in a parameter named {extra.name!r}; name "
            f"it 'position' to make the contract explicit",
            UserWarning, stacklevel=3)
        return "pos"
    warnings.warn(
        f"datarep callback {getattr(fn, '__name__', fn)!r} has a trailing "
        f"defaulted parameter {extra.name!r}; only a parameter named "
        f"'position' receives the element position — {extra.name!r} keeps "
        f"its default (rename it to 'position' to opt in)",
        UserWarning, stacklevel=3)
    return ""


class Datarep:
    """How etype elements are represented IN THE FILE (``mpi_tpu/io.py:126``):
    ``read_fn`` (file bytes -> ndarray), ``write_fn`` (ndarray -> file
    bytes) and ``extent_fn(etype, extra) -> int``, the bytes ONE element
    occupies in the file (default ``etype.itemsize``).  Conversions are
    elementwise, so views, shared pointers and collective buffering keep
    working in etype units with only the byte math rescaled.  A callback
    declaring the trailing ``position`` parameter receives the
    VIEW-relative etype index of its first element."""

    def __init__(self, name: str, read_fn, write_fn, extent_fn=None,
                 extra_state=None):
        self.name = name
        self._read, self._write = read_fn, write_fn
        self._extent, self._extra = extent_fn, extra_state
        self._read_pos = _wants_position(read_fn, 4)
        self._write_pos = _wants_position(write_fn, 3)

    def file_extent(self, etype: np.dtype) -> int:
        e = (int(self._extent(etype, self._extra)) if self._extent
             else etype.itemsize)
        if e <= 0:
            raise ValueError(
                f"datarep {self.name!r}: file extent must be positive, "
                f"got {e} for etype {etype}")
        return e

    def read(self, raw: bytes, etype: np.dtype, count: int,
             position: int = 0) -> np.ndarray:
        if self._read_pos == "pos":
            out = self._read(raw, etype, count, self._extra, int(position))
        elif self._read_pos == "kw":
            out = self._read(raw, etype, count, self._extra,
                             position=int(position))
        else:
            out = self._read(raw, etype, count, self._extra)
        out = np.asarray(out, dtype=etype)
        if out.size != count:
            raise ValueError(
                f"datarep {self.name!r} read conversion returned "
                f"{out.size} elements for {count} requested")
        return out

    def write(self, arr: np.ndarray, etype: np.dtype, position: int = 0):
        """The file-representation bytes (``bytes``, or a zero-copy
        ``memoryview`` for the identity representation)."""
        if self._write_pos == "pos":
            raw = self._write(arr, etype, self._extra, int(position))
        elif self._write_pos == "kw":
            raw = self._write(arr, etype, self._extra,
                              position=int(position))
        else:
            raw = self._write(arr, etype, self._extra)
        want = arr.size * self.file_extent(etype)
        if len(raw) != want:
            raise ValueError(
                f"datarep {self.name!r} write conversion emitted "
                f"{len(raw)} bytes for {arr.size} elements "
                f"(extent says {want})")
        return raw


_NATIVE = Datarep(
    "native",
    lambda raw, et, n, _: np.frombuffer(raw, dtype=et, count=n).copy(),
    lambda arr, et, _: memoryview(arr).cast("B"))

_DATAREPS = {
    # memory representation IS the file representation: the write side
    # hands back a zero-copy view of the array's own buffer, and a read
    # lands in the result's own memory (File._read_raw)
    "native": _NATIVE,
    # the portable big-endian interchange format (datatypes.pack_external
    # for simple etypes)
    "external32": Datarep(
        "external32",
        lambda raw, et, n, _: np.frombuffer(
            raw, dtype=et.newbyteorder(">"), count=n).astype(et),
        lambda arr, et, _: np.ascontiguousarray(arr).astype(
            arr.dtype.newbyteorder(">"), copy=False).tobytes()),
}


def register_datarep(name: str, read_fn, write_fn, extent_fn=None,
                     extra_state=None) -> None:
    """MPI_Register_datarep: make ``name`` usable as ``set_view``'s
    ``datarep`` process-wide.  Redefining a predefined or registered
    representation is erroneous (MPI_ERR_DUP_DATAREP)."""
    if name in _DATAREPS:
        raise ValueError(f"datarep {name!r} already registered "
                         f"(MPI_ERR_DUP_DATAREP)")
    _DATAREPS[name] = Datarep(name, read_fn, write_fn, extent_fn,
                              extra_state)


def _np_dtype(etype: Any) -> np.dtype:
    """A view's etype as a numpy dtype; torch dtypes map to theirs."""
    if isinstance(etype, torch.dtype):
        try:
            return torch.empty(0, dtype=etype).numpy().dtype
        except TypeError:
            raise ValueError(
                f"etype {etype} has no numpy counterpart, so no datarep "
                f"can convert it; view its bytes as an integer etype of "
                f"the same width") from None
    return np.dtype(etype)


def _stage(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host ndarray: a CPU tensor by reference, a
    card tensor by ONE copy into pinned host memory (blocking)."""
    t = t.detach()
    if t.device.type != "cpu":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    return t.numpy()


def _host_array(data: Any, etype: np.dtype) -> np.ndarray:
    """``data`` (tensor, ndarray, sequence) as a C-contiguous host array of
    ``etype``."""
    if isinstance(data, torch.Tensor):
        data = _stage(data)
    return np.ascontiguousarray(np.asarray(data, dtype=etype))


def _pwrite_full(fd: int, view, offset: int) -> None:
    """pwrite the whole buffer (one syscall caps at ~2 GiB on Linux; a
    short write would silently truncate the transfer)."""
    pos = 0
    n = len(view)
    while pos < n:
        w = os.pwrite(fd, view[pos:], offset + pos)
        if w <= 0:
            raise OSError(f"pwrite returned {w} at offset {offset + pos}")
        pos += w


def _pread_into(fd: int, view: memoryview, offset: int) -> int:
    """pread into ``view`` until full or true EOF (a capped syscall is not
    EOF); returns the bytes read."""
    got = 0
    n = len(view)
    while got < n:
        r = os.preadv(fd, [view[got:]], offset + got)
        if r <= 0:
            break  # EOF
        got += r
    return got


class File:
    """An open parallel file (MPI_File).  Construct via :func:`file_open`."""

    def __init__(self, comm: Communicator, path: str, amode: int):
        if not isinstance(comm, P2PCommunicator):
            raise NotImplementedError(
                "MPI-IO files live on process ranks (fds + window server); "
                "open with a process-backend comm (COMM_WORLD under the "
                "launcher, or COMM_SELF for private files).  For sharded "
                "card state use mpi_tpu_torch.checkpoint.")
        if not (amode & (MODE_RDONLY | MODE_WRONLY | MODE_RDWR)):
            raise ValueError("amode needs one of MODE_RDONLY/WRONLY/RDWR")
        self._comm = comm
        self._path = path
        self._amode = amode
        # the collective create/truncate decision happens once, at rank
        # 0; the OUTCOME is broadcast so a failure raises on every rank
        # instead of leaving peers in the barrier
        err: Optional[str] = None
        if comm.rank == 0:
            try:
                if amode & MODE_CREATE:
                    flags = os.O_CREAT | (os.O_EXCL if amode & MODE_EXCL else 0)
                    fd = os.open(path, flags | os.O_RDWR, 0o644)
                    os.close(fd)
                elif not os.path.exists(path):
                    raise OSError(f"file {path!r} does not exist "
                                  "(open without MODE_CREATE)")
            except OSError as e:
                err = f"{type(e).__name__}: {e}"
        err = comm.bcast(err, 0)
        if err is not None:
            raise OSError(f"collective open failed at rank 0: {err}")
        oflag = (os.O_RDONLY if amode & MODE_RDONLY and
                 not (amode & (MODE_WRONLY | MODE_RDWR)) else os.O_RDWR)
        self._fd = os.open(path, oflag)
        # the view: displacement (bytes), etype, optional filetype map and
        # the data representation
        self._disp = 0
        self._etype = np.dtype(np.uint8)
        self._filetype: Optional[Datatype] = None
        self._datarep = _NATIVE
        self._file_es = 1  # bytes per etype element IN THE FILE
        self._pos = 0            # individual pointer, etype units in view
        self._shared_win = None  # passive-target counter at rank 0
        self._open = True
        if amode & MODE_APPEND:
            self._pos = self._visible_end()

    # -- views -------------------------------------------------------------

    def set_view(self, disp: int = 0, etype: Any = np.uint8,
                 filetype: Optional[Datatype] = None,
                 datarep: str = "native") -> None:
        """MPI_File_set_view: offsets become etype-relative and the
        filetype's index map selects which file elements this rank sees;
        collective (each rank passes its OWN view — disjoint filetypes
        partition the file).  ``datarep``: "native", "external32" or a
        name registered with :func:`register_datarep`."""
        et = _np_dtype(etype)
        try:
            rep = _DATAREPS[datarep]
        except KeyError:
            raise ValueError(
                f"unknown datarep {datarep!r}; have {sorted(_DATAREPS)} "
                f"(register custom representations with "
                f"register_datarep)") from None
        if filetype is not None:
            if filetype.base_dtype != et and filetype.base_dtype != np.uint8:
                raise ValueError(
                    f"filetype base {filetype.base_dtype} != etype {et}")
            filetype.commit()  # no overlap within one instance
            if filetype.indices.size:
                if filetype.extent <= 0:
                    raise ValueError("filetype extent must be positive "
                                     "for a view (it is the tiling period)")
                # the view tiles the map indefinitely: two instances
                # collide iff two indices are congruent mod extent.  MPI
                # permits that on read-only files only.
                if self._amode & (MODE_WRONLY | MODE_RDWR):
                    res = filetype.indices % filetype.extent
                    if np.unique(res).size != res.size:
                        raise ValueError(
                            "filetype instances overlap when tiled (two "
                            "element displacements are congruent modulo the "
                            f"extent {filetype.extent}) — writes through "
                            "this view would silently collide (legal on a "
                            "MODE_RDONLY file)")
        self._disp = int(disp)
        self._etype = et
        self._filetype = filetype
        self._datarep = rep
        self._file_es = rep.file_extent(et)
        self._pos = 0
        self._comm.barrier()

    def get_view(self):
        return (self._disp, self._etype, self._filetype,
                self._datarep.name)

    # -- offset translation ------------------------------------------------

    def _byte_runs(self, offset: int, nelems: int) -> List[Tuple[int, int]]:
        """Visible [offset, offset+nelems) etype elements -> coalesced
        (file byte offset, nbytes) runs, in FILE-side element sizes."""
        es = self._file_es
        if nelems <= 0:
            return []
        if self._filetype is None:
            return [(self._disp + offset * es, nelems * es)]
        ft = self._filetype
        k = ft.indices.size
        if k == 0:
            raise ValueError("filetype selects zero elements")
        i = np.arange(offset, offset + nelems, dtype=np.int64)
        file_elems = ft.indices[i % k] + (i // k) * ft.extent
        if ft.base_dtype == np.uint8 and self._etype.itemsize != 1:
            raise ValueError("byte-based filetype with non-byte etype is "
                             "ambiguous; build the filetype over the etype")
        starts = self._disp + file_elems * es
        # a run breaks wherever neighbors are not exactly one element apart
        breaks = np.flatnonzero(np.diff(starts) != es)
        run_starts = starts[np.concatenate(([0], breaks + 1))]
        counts = np.diff(np.concatenate(([0], breaks + 1, [starts.size])))
        return [(int(s), int(c) * es) for s, c in zip(run_starts, counts)]

    # -- explicit offsets (independent) ------------------------------------

    def _to_file_rep(self, data: Any,
                     position: int = 0) -> Tuple[np.ndarray, memoryview]:
        """Coerce to etype on the host (a card tensor staged once) and run
        the view's datarep write conversion; returns (memory array,
        file-representation bytes)."""
        arr = _host_array(data, self._etype)
        return arr, memoryview(
            self._datarep.write(arr, self._etype, position))

    def _write_runs(self, offset: int, nelems: int, view) -> None:
        """pwrite converted bytes across the view's byte runs."""
        pos = 0
        for start, nbytes in self._byte_runs(int(offset), nelems):
            _pwrite_full(self._fd, view[pos:pos + nbytes], start)
            pos += nbytes

    def write_at(self, offset: int, data: Any) -> int:
        """pwrite ``data`` at view-relative ``offset`` (etype units);
        returns elements written."""
        self._check_open()
        arr, view = self._to_file_rep(data, int(offset))
        self._write_runs(offset, arr.size, view)
        return arr.size

    def _read_raw(self, offset: int, count: int) -> Tuple[torch.Tensor, int]:
        """pread the view's runs for ``count`` elements into one host
        buffer (pinned when the communicator is on a card); stops at true
        EOF inside a run.  Returns (uint8 buffer, bytes read)."""
        runs = self._byte_runs(int(offset), int(count))
        total = sum(n for _, n in runs)
        buf = torch.empty(total, dtype=torch.uint8,
                          pin_memory=self._comm.device.type == "cuda")
        view = memoryview(buf.numpy())
        got = 0
        for start, nbytes in runs:
            r = _pread_into(self._fd, view[got:got + nbytes], start)
            got += r
            if r < nbytes:  # true EOF inside a run
                break
        return buf, got

    def read_at(self, offset: int, count: int) -> torch.Tensor:
        """pread ``count`` etype elements at view-relative ``offset``,
        converted from the view's datarep, as a tensor on the
        communicator's device; a short read at EOF returns fewer
        elements (MPI: the count via Get_count)."""
        self._check_open()
        buf, got = self._read_raw(offset, count)
        nel = got // self._file_es
        nbytes = nel * self._file_es
        if self._datarep is _NATIVE:
            # the bytes ARE the elements: the buffer itself, no conversion
            out = buf[:nbytes].view(
                torch.from_numpy(np.empty(0, self._etype)).dtype)
        else:
            arr = self._datarep.read(bytes(memoryview(buf.numpy())[:nbytes]),
                                     self._etype, nel, int(offset))
            if not arr.flags.writeable or not arr.flags.c_contiguous:
                arr = np.array(arr, order="C")
            out = torch.from_numpy(arr)
        return out.to(self._comm.device)

    # -- individual file pointer -------------------------------------------

    def _visible_end(self) -> int:
        """VISIBLE etype elements the file holds under this view (SEEK_END
        counts through the filetype, not raw bytes)."""
        es = self._file_es
        nbytes = self.get_size() - self._disp
        if nbytes <= 0:
            return 0
        if self._filetype is None:
            return nbytes // es
        ft = self._filetype
        inst_bytes = ft.extent * es
        full = nbytes // inst_bytes
        rem = nbytes % inst_bytes
        extra = int(np.sum((ft.indices + 1) * es <= rem))
        return int(full) * ft.indices.size + extra

    def seek(self, offset: int, whence: int = SEEK_SET) -> None:
        self._check_open()
        if whence == SEEK_SET:
            pos = int(offset)
        elif whence == SEEK_CUR:
            pos = self._pos + int(offset)
        elif whence == SEEK_END:
            pos = self._visible_end() + int(offset)
        else:
            raise ValueError(f"bad whence {whence}")
        if pos < 0:
            raise ValueError(f"negative file position {pos}")
        self._pos = pos  # assigned only after validation

    def get_position(self) -> int:
        return self._pos

    def write(self, data: Any) -> int:
        n = self.write_at(self._pos, data)
        self._pos += n
        return n

    def read(self, count: int) -> torch.Tensor:
        out = self.read_at(self._pos, count)
        self._pos += out.numel()
        return out

    # -- shared file pointer -----------------------------------------------

    def _shared_fetch_add(self, n: int) -> int:
        """Atomic fetch-and-add on the rank-0 shared pointer: one server
        round trip (MPI_Fetch_and_op)."""
        if self._shared_win is None:
            raise RuntimeError(
                "shared file pointer not initialized — open the file with "
                "file_open(..., shared=True) (collective) to use "
                "read_shared/write_shared")
        old = self._shared_win.fetch_and_op(
            0, torch.tensor([n], dtype=torch.int64))
        return int(torch.as_tensor(old).reshape(-1)[0])

    def init_shared(self) -> None:
        """Collective: create the shared-pointer window, a host counter
        (done by ``file_open(..., shared=True)``)."""
        if self._shared_win is None:
            self._shared_win = self._comm.win_create(
                torch.zeros(1, dtype=torch.int64))

    def seek_shared(self, offset: int) -> None:
        """Collective in MPI; here rank-atomic: set the shared pointer."""
        w = self._shared_win
        if w is None:
            raise RuntimeError("file not opened with shared=True")
        w.lock(0, exclusive=True)
        w.put_at(0, torch.tensor([int(offset)], dtype=torch.int64))
        w.unlock(0)

    def write_shared(self, data: Any) -> int:
        """MPI_File_write_shared: each call atomically claims the next
        region — records never overlap, their order is the race's."""
        arr = _host_array(data, self._etype)
        at = self._shared_fetch_add(arr.size)
        return self.write_at(at, arr)

    def read_shared(self, count: int) -> torch.Tensor:
        at = self._shared_fetch_add(int(count))
        return self.read_at(at, count)

    # -- ordered shared-pointer collectives --------------------------------

    def _ordered_base(self, nelems: int) -> int:
        """Collective: a contiguous region ordered BY RANK (an exscan of
        sizes); rank 0 advances the shared pointer past the whole epoch."""
        if self._shared_win is None:
            raise RuntimeError("file not opened with shared=True")
        sizes = [int(s) for s in self._comm.allgather(int(nelems))]
        prefix = sum(sizes[: self._comm.rank])
        total = sum(sizes)
        base = self._shared_fetch_add(total) if self._comm.rank == 0 else None
        base = self._comm.bcast(base, 0)
        self._comm.barrier()
        return int(base) + prefix

    def write_ordered(self, data: Any) -> int:
        """MPI_File_write_ordered: like write_shared, records in RANK
        order; collective."""
        arr = _host_array(data, self._etype)
        at = self._ordered_base(arr.size)
        n = self.write_at(at, arr)
        self._comm.barrier()
        return n

    def read_ordered(self, count: int) -> torch.Tensor:
        """MPI_File_read_ordered: collective rank-ordered read through the
        shared pointer."""
        at = self._ordered_base(int(count))
        out = self.read_at(at, count)
        self._comm.barrier()
        return out

    # -- collective I/O ----------------------------------------------------

    def write_at_all(self, offset: int, data: Any) -> int:
        """MPI_File_write_at_all with two-phase collective buffering: small
        epochs aggregate at rank 0 and hit the file as ONE offset-sorted
        sweep; large payloads write independently inside the same barrier
        bracket."""
        self._check_open()
        arr, view = self._to_file_rep(data, int(offset))
        total = int(self._comm.allreduce(len(view)))
        # the branch is COLLECTIVE: every rank compares the allreduced
        # total against RANK 0's limit, so a limit changed on some ranks
        # cannot split the control flow
        limit = self._comm.bcast(_COLLECTIVE_BUFFER_LIMIT, 0)
        if total > limit:
            self._write_runs(int(offset), arr.size, view)
            self._comm.barrier()
            return arr.size
        # phase 1: ship (run, bytes) lists to the aggregator
        payload, pos = [], 0
        for start, nbytes in self._byte_runs(int(offset), arr.size):
            payload.append((start, bytes(view[pos:pos + nbytes])))
            pos += nbytes
        if self._comm.rank == 0:
            everyone = [payload] + [
                self._comm._recv_internal(r, _TAG_TWOPHASE)
                for r in range(1, self._comm.size)]
            # phase 2: one sorted sequential sweep
            flat = sorted((s, b) for rankruns in everyone for s, b in rankruns)
            for start, blob in flat:
                _pwrite_full(self._fd, memoryview(blob), start)
        else:
            self._comm._send_internal(payload, 0, _TAG_TWOPHASE)
        self._comm.barrier()
        return arr.size

    def read_at_all(self, offset: int, count: int) -> torch.Tensor:
        """Collective read: barrier-bracketed independent preads."""
        self._comm.barrier()
        out = self.read_at(offset, count)
        self._comm.barrier()
        return out

    # -- sizes / sync / lifecycle ------------------------------------------

    def get_size(self) -> int:
        self._check_open()
        return os.fstat(self._fd).st_size

    def set_size(self, size: int) -> None:
        """Collective truncate/extend."""
        self._check_open()
        if self._comm.rank == 0:
            os.ftruncate(self._fd, int(size))
        self._comm.barrier()

    def preallocate(self, size: int) -> None:
        self.set_size(max(self.get_size(), int(size)))

    def sync(self) -> None:
        self._check_open()
        os.fsync(self._fd)

    def close(self) -> None:
        """Collective close; honors MODE_DELETE_ON_CLOSE."""
        if not self._open:
            return
        os.fsync(self._fd)
        self._comm.barrier()
        os.close(self._fd)
        self._open = False
        if self._shared_win is not None:
            self._shared_win.free()
            self._shared_win = None
        if self._amode & MODE_DELETE_ON_CLOSE and self._comm.rank == 0:
            try:
                os.unlink(self._path)
            except OSError:
                pass
        self._comm.barrier()

    def _check_open(self) -> None:
        if not self._open:
            raise RuntimeError("file is closed")

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def file_open(comm: Communicator, path: str, amode: int = MODE_RDWR,
              shared: bool = False, info: Optional[dict] = None) -> File:
    """MPI_File_open (collective).  ``shared=True`` also creates the
    shared-file-pointer window (needed by read/write_shared and the
    ordered calls).  ``info``: MPI_Info hints, accepted as advisory
    no-ops."""
    del info
    f = File(comm, path, amode)
    if shared:
        f.init_shared()
    return f


def file_delete(path: str) -> None:
    """MPI_File_delete."""
    os.unlink(path)
