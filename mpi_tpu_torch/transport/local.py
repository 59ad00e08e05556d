"""In-process transport: rank = thread, channel = shared mailbox — the
port's own copy of ``mpi_tpu/transport/local.py`` (``LocalWorld``,
``LocalTransport``, ``run_local`` :61).

Payloads are copied by default so ranks cannot share mutable state
through a message: a tensor is cloned on its own device (on the card the
clone is a device-to-device copy), anything else is deep-copied.

Streams: every rank thread launches its kernels (clones, folds, copies)
on the device's default stream, so a sender's clone is ordered before the
receiver's fold by host order alone — the mailbox handoff needs no CUDA
event.  Giving rank threads streams of their own would need one.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from . import codec
from .base import Mailbox, Transport


class LocalWorld:
    """Shared state for one in-process world of ``size`` ranks."""

    def __init__(self, size: int, copy_payloads: bool = True,
                 device=None) -> None:
        self.size = size
        self.copy_payloads = copy_payloads
        self.device = device
        self.mailboxes = [Mailbox() for _ in range(size)]


class LocalTransport(Transport):

    def __init__(self, world: LocalWorld, rank: int) -> None:
        super().__init__(rank, world.size, world.device)
        self._world = world
        self.mailbox = world.mailboxes[rank]
        self.aliases_payloads = not world.copy_payloads

    def send(self, dest: int, ctx, tag: int, payload: Any) -> None:
        if not (0 <= dest < self.world_size):
            raise ValueError(f"dest {dest} out of range for world size {self.world_size}")
        if self._world.copy_payloads:
            payload = codec.local_copy(payload)
        self._world.mailboxes[dest].deliver(self.world_rank, ctx, tag, payload)

    def close(self) -> None:
        self.mailbox.close()


def run_local(fn: Callable, nranks: int, args: Sequence = (),
              kwargs: Optional[dict] = None, timeout: float = 120.0,
              copy_payloads: bool = True, device=None,
              recv_timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(comm, *args, **kwargs)`` on ``nranks`` in-process rank
    threads; return the per-rank results as a list indexed by rank.
    ``device`` is the device every rank's ``comm.device`` names: the card
    when None (raising where there is none), the CPU only when asked for.
    An error on one rank closes every mailbox (unblocking its peers) and
    is re-raised as ``RuntimeError("rank r failed: ...")``."""
    from ..communicator import P2PCommunicator
    from ..gpu import primitives
    from ..gpu.runner import resolve_device

    device = resolve_device(device)
    kwargs = kwargs or {}
    world = LocalWorld(nranks, copy_payloads=copy_payloads, device=device)
    results: List[Any] = [None] * nranks
    errors: List[tuple] = []
    lock = threading.Lock()

    def runner(r: int) -> None:
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)  # the device is per thread
            primitives.bind_host_rank(r, device)
            comm = P2PCommunicator(LocalTransport(world, r), range(nranks), recv_timeout=recv_timeout)
            results[r] = fn(comm, *args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - propagated to caller below
            with lock:
                errors.append((r, e, traceback.format_exc()))
            for mb in world.mailboxes:  # unblock peers waiting on this rank
                mb.close()

    threads = [threading.Thread(target=runner, args=(r,),
                                name=f"mpi-tpu-torch-rank-{r}", daemon=True)
               for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    stuck = [t for t in threads if t.is_alive()]
    if stuck:
        # where each stuck rank is blocked: the actionable part of a
        # deadlock report
        frames = sys._current_frames()
        where = []
        for t in stuck:
            frame = frames.get(t.ident)
            if frame is not None:
                loc = traceback.extract_stack(frame)[-1]
                where.append(f"{t.name} at {loc.filename}:{loc.lineno} in {loc.name}")
            else:
                where.append(t.name)
        for mb in world.mailboxes:
            mb.close()
        raise TimeoutError(
            f"ranks did not finish within {timeout}s (likely deadlock): {where}")
    if errors:
        r, e, tb = errors[0]
        raise RuntimeError(f"rank {r} failed:\n{tb}") from e
    return results
