"""In-process transport: rank = thread, channel = shared mailbox — the
port's own copy of ``mpi_tpu/transport/local.py`` (``LocalWorld``,
``LocalTransport`` with the verifier's send stamp (:49) and its tuning key
(:36), ``KILLED`` :58, ``run_local`` :61 with its ``tuning_table``
(:130), ``transport_wrapper``, ``fault_tolerance``
(the in-memory beat table, :159), ``verify`` (one shared ``MemoryBoard``
per world, :160-167), ``trace`` (the flight recorder, :125) and
``progress`` keywords, and the world comm's generation mark :88).

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


KILLED = object()  # result-slot sentinel: this rank died by injection


class LocalWorld:
    """Shared state for one in-process world of ``size`` ranks."""

    def __init__(self, size: int, copy_payloads: bool = True,
                 device=None) -> None:
        self.size = size
        self.copy_payloads = copy_payloads
        self.device = device
        self.mailboxes = [Mailbox() for _ in range(size)]


class LocalTransport(Transport):
    # tuned-dispatch table key (tuning/)
    tuning_transport = "local"

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
        vc = self.verify_clock
        stamp = vc.tick_send() if vc is not None else None
        self._world.mailboxes[dest].deliver(self.world_rank, ctx, tag,
                                            payload, stamp)

    def close(self) -> None:
        self.mailbox.close()


def run_local(fn: Callable, nranks: int, args: Sequence = (),
              kwargs: Optional[dict] = None, timeout: float = 120.0,
              copy_payloads: bool = True, device=None,
              recv_timeout: Optional[float] = None,
              transport_wrapper: Optional[Callable[[Transport], Transport]] = None,
              fault_tolerance: bool = False,
              progress: Optional[str] = None, verify: bool = False,
              trace: bool = False,
              tuning_table: Optional[str] = None) -> List[Any]:
    """Run ``fn(comm, *args, **kwargs)`` on ``nranks`` in-process rank
    threads; return the per-rank results as a list indexed by rank.
    ``device`` is the device every rank's ``comm.device`` names: the card
    when None (raising where there is none), the CPU only when asked for.
    An error on one rank closes every mailbox (unblocking its peers) and
    is re-raised as ``RuntimeError("rank r failed: ...")``.

    ``transport_wrapper`` interposes at the plugin boundary (fault
    injection: ``FaultyTransport.wrapper(...)``, recorders).
    ``fault_tolerance=True`` enables ULFM (``ft.py``) on every rank over
    one shared in-memory beat table: a rank killed by injection
    (``KilledRankError``) records :data:`KILLED` in its slot and — unlike a
    real error — closes no mailbox, so the survivors detect, revoke and
    shrink as against a dead process.  A rank whose ``fn`` returns stops
    beating, so long-running survivors eventually see it as failed.
    ``progress="thread"`` starts one progress engine per rank
    (``progress.py``); None defers to MPI_TPU_PROGRESS and the
    ``progress`` cvar.

    ``verify=True`` enables the runtime verifier (``verify/``) on every
    rank over one shared in-memory pending-op board: deadlocks raise
    DeadlockError instead of hanging, divergent collectives
    CollectiveMismatchError, and the request/buffer lints land in
    ``verify.take_report()`` and the ``verify_*`` pvars.  A rank whose
    ``fn`` returns publishes 'exited', so a peer blocked on it is
    diagnosed.  ``trace=True`` enables the flight recorder
    (``telemetry/``): one process-wide ring (rank threads are told apart
    by tid), left active afterwards for ``telemetry.recorder().dump()``
    / ``telemetry.export_chrome(path)``; call ``telemetry.disable()``
    when done.  ``tuning_table`` activates a tuned-dispatch table
    (``tuning/``) for this world and restores the previous one after."""
    from .. import progress as _progress
    from .. import tuning as _tuning
    from ..communicator import P2PCommunicator
    from ..gpu import primitives
    from ..gpu.runner import resolve_device
    from .faulty import KilledRankError

    device = resolve_device(device)
    if trace:
        from .. import telemetry as _telemetry

        _telemetry.enable()
    progress_mode = _progress.resolve_mode(progress)
    prev_table = None
    if tuning_table is not None:
        prev_table = _tuning.table_path()
        _tuning.set_table_path(tuning_table)
    kwargs = kwargs or {}
    world = LocalWorld(nranks, copy_payloads=copy_payloads, device=device)
    results: List[Any] = [None] * nranks
    errors: List[tuple] = []
    lock = threading.Lock()
    liveness = None
    if fault_tolerance:
        from .. import ft as _ft

        liveness = _ft.MemoryLiveness(nranks)
    board = None
    if verify:
        from ..verify import MemoryBoard

        board = MemoryBoard(nranks)

    def runner(r: int) -> None:
        ft_state = v_state = engine = None
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)  # the device is per thread
            primitives.bind_host_rank(r, device)
            t: Transport = LocalTransport(world, r)
            if transport_wrapper is not None:
                t = transport_wrapper(t)
            comm = P2PCommunicator(t, range(nranks), recv_timeout=recv_timeout)
            comm._mark_generation()  # the world comm: its shrink bumps the epoch
            if liveness is not None:
                from .. import ft as _ft

                ft_state = _ft.enable(comm, liveness=liveness)._ft
            if board is not None:
                from .. import verify as _verify

                v_state = _verify.enable(comm, board=board)._verify
            if progress_mode == "thread":
                engine = _progress.enable(comm)._progress
            results[r] = fn(comm, *args, **kwargs)
            if v_state is not None:
                v_state.world.mark_exited()
        except BaseException as e:  # noqa: BLE001 - propagated to caller below
            if isinstance(e, KilledRankError):
                # simulated crash-stop: the rank is gone, the WORLD lives
                # on and the survivors detect and recover on their own
                results[r] = KILLED
                return
            with lock:
                errors.append((r, e, traceback.format_exc()))
            for mb in world.mailboxes:  # unblock peers waiting on this rank
                mb.close()
        finally:
            if ft_state is not None:
                ft_state.world.stop()
            if engine is not None:
                engine.stop()

    threads = [threading.Thread(target=runner, args=(r,),
                                name=f"mpi-tpu-torch-rank-{r}", daemon=True)
               for r in range(nranks)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
    finally:
        if prev_table is not None:
            try:
                _tuning.set_table_path(prev_table or None)
            except _tuning.TuningTableError:
                _tuning.set_table_path(None)  # the prior table went away
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
