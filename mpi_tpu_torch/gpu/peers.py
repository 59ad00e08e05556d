"""The exchange of SPMD worlds that span processes.

Where a world's ranks live in several processes (``gpu/multihost.py``),
each process holds the ``[count, ...]`` rows of its own ranks, and a
world-level rule needs the others' (``primitives.spanning``).  The
reference leaves this to its runtime: ``jax.distributed`` with gloo on the
CPU (``mpi_tpu/tpu/multihost.py:52-54``), the interconnect on a pod.  Here:

* on the CPU, ``torch.distributed.all_gather`` over the gloo process group
  that ``multihost.init_distributed`` joined (``HostExchange``);
* on the card, CUDA IPC (``CardExchange``, ``csrc/peers.cu``).  Each
  process owns one staging buffer from ``cudaMalloc``, grown by doubling;
  each growth bumps a generation number.  Its IPC handle, size and
  generation go to every peer with each exchange's first barrier, and a
  peer opens a handle once per generation and keeps the mapping until
  ``destroy`` (at exit at the latest).  A process reads its own ranks from
  its own memory (``cudaIpcOpenMemHandle`` refuses a handle of its own
  process).

One exchange on the card, in order: copy the local world into staging;
synchronize the stream; host barrier (which carries every process's
generation and handle); read (``gather``: a tensor over each peer's mapped
pointer, zero copy, concatenated; ``peer_rows``: a device table of per-rank
row pointers for the ring kernel); synchronize; host barrier before staging
is written again.  No kernel waits on a flag another process writes: two
processes on one card are time-sliced, not co-resident.  Any IPC failure
raises, naming the call and the CUDA error; there is no fallback.

Each process gathers the whole world: P/count times the bytes its own
ranks need (``stats`` counts them).
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

_EXCHANGES: Dict[str, "HostExchange"] = {}


def _require_world() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a world that spans processes needs the process group of "
            "mpi_tpu_torch.gpu.multihost.init_distributed (or auto_init "
            "under the simulated-host launcher)")


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(parts: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """The ``[nprocs * count, ...]`` world of the byte rows in ``parts``."""
    return torch.cat(parts).view(like.dtype).reshape(
        (len(parts) * like.shape[0],) + tuple(like.shape[1:]))


class HostExchange:
    """The exchange of CPU worlds: one gloo ``all_gather`` a call."""

    def __init__(self) -> None:
        _require_world()
        self.nprocs = dist.get_world_size()
        self.rank = dist.get_rank()
        # exchanges made, bytes this process put in and bytes it took in
        self.stats = {"exchanges": 0, "local_bytes": 0, "world_bytes": 0}

    def _count(self, local: torch.Tensor) -> None:
        nbytes = local.numel() * local.element_size()
        self.stats["exchanges"] += 1
        self.stats["local_bytes"] += nbytes
        self.stats["world_bytes"] += nbytes * self.nprocs

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every process's ``[count, ...]`` rows, in process order: the
        ``[nprocs * count, ...]`` world."""
        self._count(local)
        flat = _as_bytes(local)
        parts = [torch.empty_like(flat) for _ in range(self.nprocs)]
        dist.all_gather(parts, flat)
        return _from_bytes(parts, local)

    def close(self) -> None:
        pass


class _Mapped:
    """``nbytes`` bytes of device memory at ``ptr``, for ``torch.as_tensor``."""

    def __init__(self, ptr: int, nbytes: int) -> None:
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


class CardExchange(HostExchange):
    """The exchange of card worlds over CUDA IPC (see the module note)."""

    def __init__(self, device: torch.device) -> None:
        super().__init__()
        from .. import _build

        self.device = device
        self._lib = _build.load("peers")
        self._handle_bytes = -(-self._lib.peers_handle_bytes() // 8) * 8
        self._ptr, self._cap, self._gen = 0, 0, 0
        self._handle = b""
        self._retired: List[int] = []   # freed once the peers dropped them
        self._peers: Dict[int, Tuple[int, int]] = {}  # q -> (generation, ptr)

    # -- CUDA calls ---------------------------------------------------------

    def _check(self, what: str, err: int) -> None:
        if err:
            buf = ctypes.create_string_buffer(256)
            self._lib.peers_error(err, buf, len(buf))
            raise RuntimeError(f"{what} failed on {self.device}: CUDA error "
                               f"{err} ({buf.value.decode()})")

    def _grow(self, nbytes: int) -> None:
        cap = max(nbytes, 2 * self._cap)
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(self._handle_bytes)
        with torch.cuda.device(self.device):
            self._check("cudaMalloc of the staging buffer",
                        self._lib.peers_alloc(ctypes.byref(ptr), cap))
            self._check("cudaIpcGetMemHandle",
                        self._lib.peers_export(ptr, handle))
        if self._ptr:
            self._retired.append(self._ptr)
        self._ptr, self._cap, self._handle = ptr.value, cap, handle.raw
        self._gen += 1

    def _open(self, q: int, gen: int, handle: bytes) -> None:
        have = self._peers.pop(q, None)
        ptr = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            if have is not None:
                self._check("cudaIpcCloseMemHandle",
                            self._lib.peers_close(have[1]))
            self._check(f"cudaIpcOpenMemHandle of process {q}'s staging",
                        self._lib.peers_open(handle, ctypes.byref(ptr)))
        self._peers[q] = (gen, ptr.value)

    def _tensor(self, ptr: int, nbytes: int) -> torch.Tensor:
        return torch.as_tensor(_Mapped(ptr, nbytes), device=self.device)

    # -- one exchange --------------------------------------------------------

    def _publish(self, local: torch.Tensor) -> int:
        """Steps 1-3: stage, synchronize, the barrier that carries every
        process's generation and handle; opens what changed."""
        nbytes = local.numel() * local.element_size()
        self._count(local)
        if nbytes > self._cap:
            self._grow(nbytes)
        if nbytes:
            self._tensor(self._ptr, nbytes).copy_(_as_bytes(local))
        torch.cuda.current_stream(self.device).synchronize()
        meta = torch.frombuffer(bytearray(
            int(self._gen).to_bytes(8, "little") + int(nbytes).to_bytes(8, "little")
            + self._handle), dtype=torch.int64)
        metas = [torch.empty_like(meta) for _ in range(self.nprocs)]
        dist.all_gather(metas, meta)
        for q, m in enumerate(metas):
            if q == self.rank:
                continue
            gen, qbytes = int(m[0]), int(m[1])
            if qbytes != nbytes:
                raise ValueError(
                    f"process {q} holds {qbytes} bytes of the world and process "
                    f"{self.rank} {nbytes}: every process must hold as many "
                    f"ranks of the same shape")
            if self._peers.get(q, (None,))[0] != gen:
                self._open(q, gen, m[2:].numpy().tobytes())
        return nbytes

    def _done(self) -> None:
        """Steps 5-6: synchronize, then the barrier after which staging may
        be written again (and a retired buffer freed: every peer has
        reopened the new one)."""
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier()
        with torch.cuda.device(self.device):
            while self._retired:
                self._check("cudaFree of a retired staging buffer",
                            self._lib.peers_free(self._retired.pop()))

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        nbytes = self._publish(local)
        try:
            parts = [_as_bytes(local) if q == self.rank
                     else self._tensor(self._peers[q][1], nbytes)
                     for q in range(self.nprocs)]
            return _from_bytes(parts, local)
        finally:
            self._done()

    @contextlib.contextmanager
    def peer_rows(self, local: torch.Tensor) -> Iterator[torch.Tensor]:
        """For the length of the block, a ``[P]`` int64 table on the device
        of every world rank's row base: this process's ranks in ``local``
        (contiguous), the others in their process's staging buffer."""
        if not local.is_contiguous():
            raise ValueError("peer_rows takes a contiguous local world")
        nbytes = self._publish(local)
        try:
            count = local.shape[0]
            row = nbytes // count if count else 0
            bases = [local.data_ptr() if q == self.rank else self._peers[q][1]
                     for q in range(self.nprocs)]
            table = torch.tensor([b + r * row for b in bases for r in range(count)],
                                 dtype=torch.int64)
            yield torch.empty_like(table, device=self.device).copy_(table)
        finally:
            self._done()

    @property
    def open_mappings(self) -> int:
        return len(self._peers)

    def close(self) -> None:
        """Close every peer mapping and free the staging buffers."""
        with torch.cuda.device(self.device):
            while self._peers:
                _, (_, ptr) = self._peers.popitem()
                self._check("cudaIpcCloseMemHandle", self._lib.peers_close(ptr))
            for ptr in self._retired + ([self._ptr] if self._ptr else []):
                self._check("cudaFree of the staging buffer",
                            self._lib.peers_free(ptr))
        self._retired, self._ptr, self._cap = [], 0, 0


def exchange(device: torch.device) -> HostExchange:
    """This process's exchange for worlds on ``device`` (made once)."""
    key = str(device)
    ex = _EXCHANGES.get(key)
    if ex is None:
        if not _EXCHANGES:
            atexit.register(destroy)
        ex = (CardExchange(device) if torch.device(device).type == "cuda"
              else HostExchange())
        _EXCHANGES[key] = ex
    return ex


def open_mappings() -> int:
    """Peer mappings this process holds open, over all its exchanges."""
    return sum(getattr(ex, "open_mappings", 0) for ex in _EXCHANGES.values())


def stats(device: Optional[torch.device] = None) -> Dict[str, int]:
    """The byte counts of ``device``'s exchange (all zero if none ran)."""
    ex = _EXCHANGES.get(str(device))
    return dict(ex.stats) if ex is not None else {
        "exchanges": 0, "local_bytes": 0, "world_bytes": 0}


def destroy() -> None:
    """Close every exchange: mappings closed, staging freed.  Called by
    ``multihost.shutdown`` and at exit."""
    while _EXCHANGES:
        _, ex = _EXCHANGES.popitem()
        ex.close()
