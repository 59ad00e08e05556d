"""Elastic membership: epochs, the rendezvous service and rejoin — the
port's own copy of ``mpi_tpu/membership.py``: incarnations and
``heartbeat_age`` (:80-152); the announce / claim / admit / ready files
and ``process_claims`` (:154-343); ``make_transport`` (:345, socket and
shm), ``survivor_transition`` (:362, with the shm readiness republish),
``rejoin_transport`` (:398), ``rejoin`` (:472) and ``accept_rejoin``
(:510); the rendezvous directory (``new_rendezvous_dir`` :569, port
publication, ``cleanup_rendezvous`` :575 with its crash-path sweep of
the session's /dev/shm segments) the launcher and the process bootstrap
use.  A verified world stays verified across a rejoin: the
joiner enables the verifier under ``MPI_TPU_VERIFY`` and the survivors'
full-world communicator shares their verifier world (:498-553); the
flight recorder logs each transition as an ``epoch_bump`` (:382).

The port adds a start barrier the reference lacks,
``await_incarnations``: a fresh fault-tolerant rank (``init()`` under
``MPI_TPU_FT``, a serve pool's worker) starts its fault detector once
every slot has published its incarnation, at most ``START_BARRIER_S``
later.  The reference starts its detector at once (``mpi_tpu/ft.py:149``
via ``init``); its ranks' start-ups (a numpy import) fall within the
detection bound, the port's (a torch import) need not.

Membership changes are EPOCH transitions.  Every world carries a
monotone epoch (``Transport.epoch``, ``comm.membership_epoch``): 0 at
start, bumped by ``shrink()`` in survivor lockstep (the bump rides the
shrink agreement; an ousted rank stays on the old epoch).  The epoch is
stamped into every socket hello, so a stale-epoch straggler is rejected
loudly (``EpochSkewError``) instead of cross-wiring two generations.

A fresh process fills a vacant slot under the next epoch:

1. the survivors (``comm.accept_rejoin()``, collective on the shrunken
   communicator) write an *announce* file ``rejoin.<epoch>.json`` listing
   the vacant slots;
2. a joiner (:func:`rejoin`, module-level: a fresh process has no
   communicator yet) *claims* a slot with an atomic ``O_EXCL`` create
   naming its incarnation id;
3. the announcer validates claims — an ousted-but-LIVE incarnation is
   refused (``RejoinRefusedError``) until its failure was
   ``failure_ack``ed; a claimer that died mid-handshake has its claim
   cleared so the slot can be claimed again — and *admits* the rest;
4. the admitted joiner creates fresh endpoints stamped with the new epoch
   (its port file atomically re-published over the corpse's), publishes
   *ready*, and both sides build the full-world communicator under
   context ``("epoch", E)`` and barrier.

Each rank publishes its port as ``<rdv>/port.<rank>`` (written to a
temporary name, then renamed, so a reader never sees a partial file).
The joiner's tensors live on its card (``device``, default the
launcher's ``MPI_TPU_DEVICE`` or card ``slot % device_count``; without a
card it raises unless ``device="cpu"``).
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import tempfile
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from . import mpit as _mpit
from . import telemetry as _telemetry
from .errors import EpochSkewError, RejoinRefusedError  # noqa: F401 (re-export)
from .transport.base import Transport, TransportError

# The environment the launcher gives each rank process (the reference's
# names): ``init`` / ``run`` read it to build the rank's socket world.
ENV_RANK = "MPI_TPU_RANK"
ENV_SIZE = "MPI_TPU_SIZE"
ENV_RDV = "MPI_TPU_RDV"
ENV_BACKEND = "MPI_TPU_BACKEND"
ENV_DEVICE = "MPI_TPU_DEVICE"

# Bound on a rejoin handshake (claim -> admit -> endpoints -> ready ->
# barrier) for both sides.
_REJOIN_TIMEOUT_S = 30.0

_POLL_S = 0.01  # rendezvous-file poll cadence

# Bound on the start barrier of a fault-tolerant world
# (``await_incarnations``): how long a fresh rank waits for every slot's
# incarnation before it starts its fault detector anyway.
START_BARRIER_S = 120.0

# Per-process incarnation id: the identity a claim presents.  ONE per
# process: an ousted live rank re-claiming its slot presents the identity
# it was ousted under, so the survivors can refuse it until failure_ack.
_PROCESS_INCARNATION: Optional[str] = None


def incarnation() -> str:
    global _PROCESS_INCARNATION
    if _PROCESS_INCARNATION is None:
        _PROCESS_INCARNATION = uuid.uuid4().hex
    return _PROCESS_INCARNATION


# -- small atomic-file helpers ------------------------------------------------


def _write_json(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # absent or mid-replace: the caller polls again


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - exists, not ours
        return True
    return True


# -- incarnation registry -----------------------------------------------------


def publish_incarnation(rdv_dir: str, rank: int,
                        inc: Optional[str] = None) -> str:
    """Record which incarnation holds world slot ``rank`` (``inc.<rank>``):
    what accept_rejoin reads to know WHO was ousted."""
    inc = inc or incarnation()
    _write_json(os.path.join(rdv_dir, f"inc.{rank}"),
                {"incarnation": inc, "pid": os.getpid()})
    return inc


def read_incarnation(rdv_dir: str, rank: int) -> Optional[str]:
    rec = _read_json(os.path.join(rdv_dir, f"inc.{rank}"))
    return rec.get("incarnation") if rec else None


def await_incarnations(rdv_dir: str, size: int,
                       timeout: float = START_BARRIER_S) -> List[int]:
    """The start barrier of a fault-tolerant world: wait until every slot
    of ``size`` has published its incarnation, or until ``timeout`` runs
    out, and return the slots still missing.  A fresh rank starts its
    fault detector after it: a detector started before a slower peer's
    first heartbeat names that peer dead for good, and a torch import
    spreads the ranks' start-ups over seconds.  A slot that never
    publishes is still named, ``detect_timeout_s`` after the bound ends.
    A rejoining rank finds every slot published and does not wait."""
    deadline = time.monotonic() + timeout
    while True:
        missing = [p for p in range(size)
                   if read_incarnation(rdv_dir, p) is None]
        if not missing or time.monotonic() >= deadline:
            return missing
        time.sleep(_POLL_S)


def heartbeat_age(rdv_dir: str, rank: int,
                  now: Optional[float] = None) -> Optional[float]:
    """Age (seconds) of slot ``rank``'s heartbeat file, or None when it was
    never published: the liveness read any membership authority shares."""
    try:
        st = os.stat(os.path.join(rdv_dir, f"hb.{rank}"))
    except OSError:
        return None
    return (time.time() if now is None else now) - st.st_mtime


# -- announce / claim / admit / ready protocol files --------------------------


def _announce_path(rdv: str, epoch: int) -> str:
    return os.path.join(rdv, f"rejoin.{epoch}.json")


def announce_rejoin(rdv_dir: str, epoch: int, slots: Dict[int, dict],
                    size: int, backend: str) -> None:
    """Write the vacancy announcement for ``epoch``: ``slots`` maps vacant
    world rank -> {"ousted": incarnation-or-None, "acked": bool}."""
    _write_json(_announce_path(rdv_dir, epoch), {
        "epoch": int(epoch), "size": int(size), "backend": backend,
        "slots": {str(s): dict(meta) for s, meta in slots.items()},
    })


def read_announce(rdv_dir: str, epoch: int) -> Optional[dict]:
    return _read_json(_announce_path(rdv_dir, epoch))


def latest_announce(rdv_dir: str) -> Optional[dict]:
    """Newest (highest-epoch) announcement in the rendezvous dir."""
    best = None
    try:
        names = os.listdir(rdv_dir)
    except OSError:
        return None
    for name in names:
        if name.startswith("rejoin.") and name.endswith(".json"):
            rec = _read_json(os.path.join(rdv_dir, name))
            if rec and (best is None or rec["epoch"] > best["epoch"]):
                best = rec
    return best


def _claim_path(rdv: str, epoch: int, slot: int) -> str:
    return os.path.join(rdv, f"claim.{epoch}.{slot}")


def claim_slot(rdv_dir: str, epoch: int, slot: int,
               inc: Optional[str] = None, pid: Optional[int] = None) -> bool:
    """Atomically claim a vacant slot (``O_EXCL`` create): exactly one
    claimer wins."""
    inc = inc or incarnation()
    try:
        fd = os.open(_claim_path(rdv_dir, epoch, slot),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        json.dump({"incarnation": inc,
                   "pid": int(pid if pid is not None else os.getpid())}, f)
    return True


def read_claim(rdv_dir: str, epoch: int, slot: int) -> Optional[dict]:
    return _read_json(_claim_path(rdv_dir, epoch, slot))


def _admit_path(rdv: str, epoch: int, slot: int) -> str:
    return os.path.join(rdv, f"admit.{epoch}.{slot}")


def _refused_path(rdv: str, epoch: int, slot: int) -> str:
    return os.path.join(rdv, f"refused.{epoch}.{slot}")


def _ready_path(rdv: str, epoch: int, slot: int) -> str:
    return os.path.join(rdv, f"ready.{epoch}.{slot}")


def publish_ready(rdv_dir: str, epoch: int, slot: int,
                  inc: Optional[str] = None) -> None:
    _write_json(_ready_path(rdv_dir, epoch, slot),
                {"incarnation": inc or incarnation(), "pid": os.getpid()})


def _unlink_all(*paths: str) -> None:
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


def process_claims(rdv_dir: str, epoch: int, slots: Dict[int, dict],
                   acked_extra: Sequence[int] = ()) -> None:
    """One validation pass over the claims of ``epoch`` (the announcer's
    step, every poll tick):

    * a claim presenting the OUSTED incarnation of an unacknowledged slot
      is REFUSED (``refused.<epoch>.<slot>``) and cleared, so a legitimate
      replacement can claim;
    * a claimer that DIED (pid gone) has its claim, admit and ready
      cleared: the slot can be claimed again under the same epoch;
    * every other claim is ADMITTED (``admit.<epoch>.<slot>`` names the
      incarnation; the joiner touches no endpoint file before it).
    """
    acked_extra = set(acked_extra)
    for slot, meta in slots.items():
        slot = int(slot)
        claim = read_claim(rdv_dir, epoch, slot)
        if claim is None:
            continue
        inc, pid = claim.get("incarnation"), claim.get("pid")
        if pid is not None and not _pid_alive(int(pid)):
            _unlink_all(_claim_path(rdv_dir, epoch, slot),
                        _admit_path(rdv_dir, epoch, slot),
                        _ready_path(rdv_dir, epoch, slot))
            continue
        ready = _read_json(_ready_path(rdv_dir, epoch, slot))
        if ready is not None and ready.get("incarnation") == inc:
            continue  # live and complete
        ousted = meta.get("ousted")
        acked = bool(meta.get("acked")) or slot in acked_extra
        if ousted is not None and inc == ousted and not acked:
            _write_json(_refused_path(rdv_dir, epoch, slot), {
                "incarnation": inc,
                "reason": "suspected-but-live incarnation: re-admission "
                          "refused until its failure is acknowledged "
                          "(failure_ack)"})
            _unlink_all(_claim_path(rdv_dir, epoch, slot),
                        _admit_path(rdv_dir, epoch, slot))
            continue
        admit = _read_json(_admit_path(rdv_dir, epoch, slot))
        if admit is None or admit.get("incarnation") != inc:
            _write_json(_admit_path(rdv_dir, epoch, slot),
                        {"incarnation": inc})


def wait_admitted(rdv_dir: str, epoch: int, slot: int, inc: str,
                  deadline: float) -> None:
    """Joiner side: block until our claim is admitted (or refused)."""
    while True:
        admit = _read_json(_admit_path(rdv_dir, epoch, slot))
        if admit is not None and admit.get("incarnation") == inc:
            return
        refused = _read_json(_refused_path(rdv_dir, epoch, slot))
        if refused is not None and refused.get("incarnation") == inc:
            raise RejoinRefusedError(
                f"rejoin of slot {slot} at epoch {epoch} refused: "
                f"{refused.get('reason', 'unspecified')}")
        if time.monotonic() > deadline:
            raise TransportError(
                f"rejoin claim for slot {slot} (epoch {epoch}) not admitted "
                f"in time")
        time.sleep(_POLL_S)


def wait_ready(rdv_dir: str, epoch: int, slots: Dict[int, dict],
               deadline: float, validate: bool = False) -> None:
    """Survivor side: block until EVERY vacant slot's replacement
    published readiness; with ``validate`` (the announcer) each tick also
    runs the claim validation pass."""
    pending = {int(s) for s in slots}
    while pending:
        if validate:
            process_claims(rdv_dir, epoch, slots)
        for s in list(pending):
            if _read_json(_ready_path(rdv_dir, epoch, s)) is not None:
                pending.discard(s)
        if not pending:
            return
        if time.monotonic() > deadline:
            raise TransportError(
                f"rejoin at epoch {epoch}: slots {sorted(pending)} published "
                f"no replacement in time")
        time.sleep(_POLL_S)


# -- transport-level transitions ----------------------------------------------


def make_transport(backend: str, rank: int, size: int, rdv_dir: str,
                   epoch: int = 0, device=None) -> Transport:
    """A process-world transport for ``rank`` with fresh endpoints stamped
    at ``epoch`` (shared by the launcher's init path and rejoin).  Under
    ``MPI_TPU_VERIFY`` its vector clock exists before its readers start: a
    peer that enabled the verifier first may already be sending stamped
    frames."""
    if backend == "socket":
        from .transport.socket import SocketTransport

        vc = None
        if os.environ.get("MPI_TPU_VERIFY", "") not in ("", "0"):
            from .verify.vclock import VClock

            vc = VClock(rank, size)
        return SocketTransport(rank, size, rdv_dir, device=device, epoch=epoch,
                               verify_clock=vc)
    if backend == "shm":
        from .transport.shm import ShmTransport

        vc = None
        if os.environ.get("MPI_TPU_VERIFY", "") not in ("", "0"):
            from .verify.vclock import VClock

            vc = VClock(rank, size)
        return ShmTransport(rank, size, rdv_dir, device=device, epoch=epoch,
                            verify_clock=vc)
    raise ValueError(f"unknown process-world backend {backend!r} "
                     f"(accepted: socket, shm)")


def survivor_transition(transport: Transport, epoch: int,
                        dead: Sequence[int]) -> None:
    """Apply an epoch transition on a surviving rank's transport: adopt
    the new epoch, require replaced slots to present it, and drop cached
    connections and link state to them (``membership_invalidate``).  The
    socket link's resume heals faults WITHIN one epoch; across the
    boundary a replaced slot's rejoiner starts fresh streams."""
    rec = _telemetry.REC
    if rec is not None:
        rec.emit("ft", "epoch_bump",
                 attrs={"epoch": int(epoch), "dead": list(map(int, dead))})
    transport.epoch = max(transport.epoch, int(epoch))
    for d in dead:
        transport.min_peer_epoch[int(d)] = int(epoch)
    transport.membership_invalidate(list(dead))
    republish = getattr(transport, "membership_republish", None)
    if republish is not None:
        republish()  # shm: re-stamp the readiness file with the new epoch


def _backend_name(t: Transport) -> str:
    name = type(t).__name__
    return {"SocketTransport": "socket", "ShmTransport": "shm"}.get(
        name, name.lower())


# -- the joiner (fresh process) ----------------------------------------------


def rejoin_transport(rdv_dir: str, slot: Optional[int] = None,
                     epoch: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[float] = None,
                     device=None) -> Tuple[Transport, dict]:
    """Claim a vacant slot and bring up epoch-stamped endpoints for it;
    returns (transport, announce)."""
    timeout = _REJOIN_TIMEOUT_S if timeout is None else timeout
    deadline = time.monotonic() + timeout
    inc = incarnation()
    while True:
        ann = (read_announce(rdv_dir, epoch) if epoch is not None
               else latest_announce(rdv_dir))
        if ann is not None:
            break
        if time.monotonic() > deadline:
            raise TransportError(
                f"rejoin: no vacancy announcement in {rdv_dir} "
                f"(epoch={'latest' if epoch is None else epoch})")
        time.sleep(_POLL_S)
    claimed = None
    while claimed is None:
        e = int(ann["epoch"])
        size = int(ann["size"])
        backend = backend or ann.get("backend") or "socket"
        candidates = ([int(slot)] if slot is not None
                      else sorted(int(s) for s in ann["slots"]))
        for s in candidates:
            ready = _read_json(_ready_path(rdv_dir, e, s))
            if ready is not None and ready.get("incarnation") == inc:
                raise RejoinRefusedError(
                    f"double rejoin: this incarnation already holds slot {s} "
                    f"at epoch {e}")
            if claim_slot(rdv_dir, e, s, inc=inc):
                claimed = s
                break
        if claimed is None:
            if time.monotonic() > deadline:
                raise TransportError(
                    f"rejoin: no claimable slot at epoch {e} "
                    f"(candidates {candidates})")
            time.sleep(_POLL_S)
            if epoch is None:
                # a newer vacancy published mid-wait must not be missed
                ann = latest_announce(rdv_dir) or ann
    wait_admitted(rdv_dir, e, claimed, inc, deadline)
    # only an admitted claimer touches endpoint files
    t = make_transport(backend, claimed, size, rdv_dir, epoch=e,
                       device=device)
    # every peer must present our epoch before we adopt its endpoints
    for p in range(size):
        if p != claimed:
            t.min_peer_epoch[p] = e
    publish_incarnation(rdv_dir, claimed, inc)
    return t, ann


def rejoin(rdv_dir: Optional[str] = None, slot: Optional[int] = None,
           epoch: Optional[int] = None, backend: Optional[str] = None,
           timeout: Optional[float] = None,
           recv_timeout: Optional[float] = None, device=None):
    """Joiner side of the rejoin protocol, run from a FRESH process
    (``rdv_dir`` defaults to the launcher's MPI_TPU_RDV): claim a vacant
    slot of the newest announcement, bring up endpoints under the
    announced epoch on ``device`` (no CPU fallback), enable fault
    tolerance (and the progress engine when MPI_TPU_PROGRESS says so),
    publish readiness and return the FULL-SIZE world communicator —
    meeting the survivors' ``accept_rejoin`` barrier."""
    from . import _rank_device, ft as _ft, progress as _progress
    from .communicator import P2PCommunicator
    from .gpu import primitives

    rdv_dir = rdv_dir or os.environ.get(ENV_RDV)
    if rdv_dir is None:
        raise ValueError("rejoin needs a rendezvous dir: pass rdv_dir= or "
                         "set MPI_TPU_RDV")
    timeout = _REJOIN_TIMEOUT_S if timeout is None else timeout
    ann = (read_announce(rdv_dir, epoch) if epoch is not None
           else latest_announce(rdv_dir))
    guess = slot if slot is not None else (
        min(int(s) for s in ann["slots"]) if ann else 0)
    dev = _rank_device(guess, device)  # raises before any claim without a card
    if dev.type == "cuda":
        import torch

        torch.cuda.set_device(dev)
    t, ann = rejoin_transport(rdv_dir, slot=slot, epoch=epoch,
                              backend=backend, timeout=timeout, device=dev)
    e = int(ann["epoch"])
    primitives.bind_host_rank(t.world_rank, dev, process=True)
    comm = P2PCommunicator(t, range(t.world_size), ("epoch", e),
                           recv_timeout=recv_timeout)._mark_generation()
    _ft.enable(comm, rdv_dir=rdv_dir)  # a fresh heartbeat over the corpse's
    if os.environ.get("MPI_TPU_VERIFY", "") not in ("", "0"):
        from . import verify as _verify

        _verify.enable(comm, rdv_dir=rdv_dir)
    if _progress.resolve_mode() == "thread":
        _progress.enable(comm)
    # stop the helper threads and close the transport before the
    # interpreter finalizes (a thread inside a torch call there aborts)
    atexit.register(comm.close_transport)
    publish_ready(rdv_dir, e, t.world_rank)
    comm.barrier()  # meets the survivors' accept_rejoin barrier
    _mpit.count(rejoins=1)
    return comm


# -- the survivors (accept side) ----------------------------------------------


def accept_rejoin(comm, timeout: Optional[float] = None):
    """Survivor side of the rejoin protocol (``P2PCommunicator.
    accept_rejoin``): ``comm`` is the SHRUNKEN communicator (its group
    says who survived; the transport's world size, which slots to refill).
    Collective over the survivors; returns the full-world communicator
    under the post-shrink epoch."""
    from . import ft as _ftm
    from .communicator import P2PCommunicator

    ft = comm._require_ft("accept_rejoin")
    t = comm._t
    rdv = getattr(t, "_rdv", None)
    if rdv is None:
        raise RuntimeError(
            "accept_rejoin needs a file-rendezvous process world (socket "
            "under the launcher); in-process local worlds have no "
            "rendezvous dir for a fresh process to join through")
    epoch = t.epoch
    full = tuple(range(t.world_size))
    dead = sorted(set(full) - set(comm._group))
    if not dead:
        raise ValueError("accept_rejoin: the world has no vacant slots")
    timeout = _REJOIN_TIMEOUT_S if timeout is None else timeout
    deadline = time.monotonic() + timeout
    if comm.rank == 0:
        acked = ft.world.acked_world
        slots = {s: {"ousted": read_incarnation(rdv, s), "acked": s in acked}
                 for s in dead}
        announce_rejoin(rdv, epoch, slots, t.world_size, _backend_name(t))
        wait_ready(rdv, epoch, slots, deadline, validate=True)
    else:
        wait_ready(rdv, epoch, {s: {} for s in dead}, deadline)
    survivor_transition(t, epoch, dead)
    for s in dead:
        ft.world.reset_rank(s)
    new = P2PCommunicator(t, full, ("epoch", epoch),
                          recv_timeout=comm.recv_timeout)._mark_generation()
    new._ft = _ftm.CommFT(ft.world, ("epoch", epoch))
    if comm._verify is not None:
        from .verify.state import CommVerify

        new._verify = CommVerify(comm._verify.world)
    new = comm._inherit_errhandler(new)
    new.barrier()  # meets every joiner's rejoin() barrier
    _mpit.count(rejoins=1)
    return new


# -- rendezvous-dir lifecycle (launcher, tests) --------------------------------


def new_rendezvous_dir(prefix: str = "mpi_tpu_torch_rdv_") -> str:
    """Create a fresh rendezvous directory (under ``TMPDIR``)."""
    return tempfile.mkdtemp(prefix=prefix)


def publish_port(rdv_dir: str, rank: int, port: int) -> None:
    """Atomically publish ``rank``'s listening port."""
    tmp = os.path.join(rdv_dir, f".port.{rank}.tmp")
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, os.path.join(rdv_dir, f"port.{rank}"))


def read_port(rdv_dir: str, rank: int) -> Optional[int]:
    """The port ``rank`` published, or None while it has not."""
    try:
        with open(os.path.join(rdv_dir, f"port.{rank}")) as f:
            text = f.read().strip()
        return int(text) if text else None
    except (FileNotFoundError, ValueError):
        return None


def cleanup_rendezvous(rdv: str) -> None:
    """Tear a rendezvous directory down, unlinking any /dev/shm segment a
    crashed rank left behind (ranks unlink their own on a clean close;
    this is the crash path)."""
    import glob

    from .transport.shm import shm_prefix

    session = os.path.basename(rdv.rstrip("/"))
    for path in glob.glob("/dev/shm/" + shm_prefix(session) + "*"):
        try:
            os.unlink(path)
        except OSError:
            pass
    shutil.rmtree(rdv, ignore_errors=True)
