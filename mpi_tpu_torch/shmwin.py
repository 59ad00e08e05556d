"""Shared-memory windows (MPI_Win_allocate_shared) — the port's own copy
of ``mpi_tpu/shmwin.py`` (``SharedWindow`` :34, ``win_allocate_shared``
:134).

All ranks of a process world on one host map ONE /dev/shm segment; each
rank's region is addressable by every other rank.  ``remote(rank)`` is
MPI_Win_shared_query and plain tensor reads and writes are the RMA.
``mmap(MAP_SHARED)`` on one host is cache coherent, so ``sync()`` is only
an ordering point; ordering between ranks is the caller's job
(``comm.barrier()`` or point-to-point), as in MPI.

The segment is host memory: ``local``, ``remote(r)`` and ``whole`` are
CPU tensors over the mapping (``torch.frombuffer``), whatever the
communicator's device.  A program with tensors on the card copies into
and out of them (a blocking copy).  A window in device memory (CUDA IPC)
is not part of this module.
"""

from __future__ import annotations

import mmap
import os
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from .communicator import Communicator, P2PCommunicator

__all__ = ["SharedWindow", "win_allocate_shared"]


def _dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


class SharedWindow:
    """One shared segment; rank r owns the region ``local``; any region is
    load/store addressable through ``remote(r)``."""

    def __init__(self, comm: P2PCommunicator, nelems: int, dtype: Any):
        self._comm = comm
        self._dtype = _dtype(dtype)
        itemsize = torch.empty(0, dtype=self._dtype).element_size()
        sizes = comm.allgather(int(nelems))
        sizes = [int(s) for s in (sizes if isinstance(sizes, list)
                                  else torch.as_tensor(sizes).reshape(-1))]
        self._sizes = sizes
        self._offsets = [0]
        for s in sizes[:-1]:
            self._offsets.append(self._offsets[-1] + s)
        total = int(sum(sizes))
        total_bytes = total * itemsize
        # rank 0 creates the segment; everyone maps the same file
        if comm.rank == 0:
            base = "/dev/shm" if os.path.isdir("/dev/shm") else None
            fd, path = tempfile.mkstemp(prefix="mpi_tpu_torch_shmwin_",
                                        dir=base)
            os.ftruncate(fd, max(total_bytes, 1))
            os.close(fd)
        else:
            path = None
        self._path = comm.bcast(path, 0)
        self._fd = os.open(self._path, os.O_RDWR)
        self._map = mmap.mmap(self._fd, max(total_bytes, 1), mmap.MAP_SHARED)
        self._buf: Optional[torch.Tensor] = (
            torch.frombuffer(self._map, dtype=self._dtype, count=total)
            if total else torch.empty(0, dtype=self._dtype))
        self._open = True
        self._sync_lock = threading.Lock()
        comm.barrier()  # all mapped before anyone stores

    # -- addressing (MPI_Win_shared_query) ---------------------------------

    def remote(self, rank: int) -> torch.Tensor:
        """Rank ``rank``'s region as a live shared view (loads AND stores
        hit the shared segment directly)."""
        self._check_open()
        if not (0 <= rank < self._comm.size):
            raise ValueError(f"rank {rank} out of range "
                             f"(size {self._comm.size})")
        off = self._offsets[rank]
        return self._buf[off:off + self._sizes[rank]]

    @property
    def local(self) -> torch.Tensor:
        return self.remote(self._comm.rank)

    @property
    def whole(self) -> torch.Tensor:
        """The entire segment (all ranks' regions, in rank order)."""
        self._check_open()
        return self._buf

    # -- synchronization ---------------------------------------------------

    def sync(self) -> None:
        """MPI_Win_sync: an ordering point for this rank's loads and
        stores (a lock round trip is the memory barrier); cross-rank
        ordering still needs comm.barrier() or point-to-point."""
        self._check_open()
        with self._sync_lock:
            pass

    def fence(self) -> None:
        """Sync + barrier: the bulk-synchronous epoch."""
        self.sync()
        self._comm.barrier()

    # -- lifecycle ---------------------------------------------------------

    def free(self) -> None:
        """Collective: detach; rank 0 unlinks after everyone detached.
        Views the caller still holds pin the mapping until they die; the
        segment's name is gone at once either way."""
        if not self._open:
            return
        self._open = False
        self._buf = None
        try:
            self._map.close()
        except BufferError:
            pass  # user-held views pin the mapping; GC reclaims it
        os.close(self._fd)
        self._comm.barrier()
        if self._comm.rank == 0:
            try:
                os.unlink(self._path)
            except OSError:
                pass
        self._comm.barrier()

    def _check_open(self) -> None:
        if not self._open:
            raise RuntimeError("shared window is freed")


def win_allocate_shared(comm: Optional[Communicator], nelems: int,
                        dtype: Any = torch.float64) -> SharedWindow:
    """MPI_Win_allocate_shared: collectively allocate one host-shared
    segment; rank r contributes ``nelems`` elements (may differ per rank,
    0 allowed)."""
    if comm is None:
        from . import init

        comm = init()
    if not isinstance(comm, P2PCommunicator):
        raise NotImplementedError(
            "shared-memory windows are load/store on host RAM — a "
            "process-backend feature (COMM_TYPE_SHARED domain); device "
            "arrays already share HBM addressing inside one SPMD program")
    return SharedWindow(comm, int(nelems), dtype)
