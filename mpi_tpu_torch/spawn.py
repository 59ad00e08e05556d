"""Dynamic process management — MPI_Comm_spawn [S: MPI-2 ch.5]; the port's
own copy of ``mpi_tpu/spawn.py`` (:1-435).

Parents collectively spawn a NEW world of child rank processes and get an
:class:`~mpi_tpu_torch.intercomm.InterComm` to it; children find their side
with :func:`comm_get_parent`.  The classic master/worker elasticity
primitive: a running job grows itself without restarting the launcher.

Wiring (all file-rendezvous TCP, like the launcher's worlds):

* the CHILD WORLD is an ordinary socket world of ``maxprocs`` ranks over a
  fresh rendezvous dir — children call ``mpi_tpu_torch.init()`` (or touch
  ``COMM_WORLD``) exactly like launcher-started programs;
* the PARENT-CHILD BRIDGE is a second socket transport over its own
  rendezvous dir spanning P parents + C children: parents take bridge
  ranks 0..P-1 (their ``comm`` rank order), children P..P+C-1.  Rank
  discovery is lazy (port files + polling), so parents can build their
  bridge endpoint before any child has started.

The children's device: the reference pins each child's JAX to the CPU
(``mpi_tpu/launcher.py:65 cpu_pinned_env``) because processes cannot share
one libtpu.  The port does what its launcher does: child ``r`` takes card
``r % device_count`` (a card can be shared between processes), and the
parent's ``MPI_TPU_DEVICE`` reaches the children with the rest of its
environment — ``--device cpu`` and ``MPI_TPU_DEVICE=cpu`` run them on the
CPU.  A child with neither a card nor ``cpu`` raises at ``init()``; it
never falls back.  Each bridge transport lives on its side's device
(the spawning communicator's, the child world's).

Rendezvous, bridge, port and reply directories are ``mtt_spawn_*`` and the
name-service registry ``mtt_names_<uid>`` (the reference's are
``mpi_tpu_*``), so the two packages' spawn traffic never meets.

The spawning communicator can be any process-backend comm (world or a
split subset) — the bridge binds to ITS members.  SPMD communicators
cannot spawn OS processes; the diagnostic points to the launcher.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import stat
import subprocess
import sys
import tempfile
import time
import uuid
from typing import List, Optional, Sequence, Tuple

from .communicator import Communicator, P2PCommunicator
from .intercomm import InterComm
from .membership import ENV_BACKEND, ENV_RANK, ENV_RDV, ENV_SIZE

ENV_PARENT_RDV = "MPI_TPU_PARENT_RDV"
ENV_PARENT_SIZE = "MPI_TPU_PARENT_SIZE"
ENV_PARENT_TOTAL = "MPI_TPU_PARENT_TOTAL"

_PREFIX = "mtt_spawn_"
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Popen handles of everything this process spawned: children are
# independent jobs (spawn does not wait), but the handles let atexit reap
# finished ones instead of leaving zombies.
_spawned: List[subprocess.Popen] = []
_bridge_dirs: List[str] = []
_child_dirs: List[str] = []
_parent_intercomm: Optional[InterComm] = None


def _cleanup() -> None:  # pragma: no cover - exit path
    """The bridges die with this process: their dirs go.  A CHILD WORLD's
    dir is removed only once every spawned child exited — late child ranks
    still discover each other through its port files (``:50``)."""
    alive = any(p.poll() is None for p in _spawned)
    for d in _bridge_dirs:
        shutil.rmtree(d, ignore_errors=True)
    if not alive:
        for d in _child_dirs:
            shutil.rmtree(d, ignore_errors=True)


atexit.register(_cleanup)


def _bridge_comm(bridge_rank: int, total: int, rdv: str,
                 device) -> P2PCommunicator:
    from .transport.socket import SocketTransport

    t = SocketTransport(bridge_rank, total, rdv, device=device)
    comm = P2PCommunicator(t, range(total))
    comm._owns_transport = True  # intercomm.free() closes the bridge socket
    return comm


def comm_spawn(argv: Sequence[str], maxprocs: int,
               comm: Optional[Communicator] = None, root: int = 0,
               env_extra: Optional[dict] = None,
               info: Optional[dict] = None) -> InterComm:
    """MPI_Comm_spawn: start ``maxprocs`` ranks of ``python argv...`` as a
    new world; returns the parent side of the parent-child intercomm.
    Collective over ``comm`` (default: this process's world); only
    ``root`` forks the children."""
    del info  # MPI_Info hints: accepted, advisory no-ops
    return _spawn_segments([(list(argv), int(maxprocs))], comm, root,
                           env_extra)


def comm_spawn_multiple(segments: Sequence[Tuple[Sequence[str], int]],
                        comm: Optional[Communicator] = None, root: int = 0,
                        env_extra: Optional[dict] = None) -> InterComm:
    """MPI_Comm_spawn_multiple: one child WORLD running different
    executables — ``segments`` is [(argv, maxprocs), ...]; child ranks are
    assigned segment by segment, in order [S]."""
    segs = [(list(a), int(n)) for a, n in segments]
    return _spawn_segments(segs, comm, root, env_extra)


def _spawn_segments(segments: List[Tuple[List[str], int]],
                    comm: Optional[Communicator], root: int,
                    env_extra: Optional[dict]) -> InterComm:
    if comm is None:
        from . import init

        comm = init()
    if not isinstance(comm, P2PCommunicator):
        raise NotImplementedError(
            "comm_spawn forks OS processes — a process-backend feature; "
            "an SPMD program's world is a device's virtual ranks, not a "
            "process pool (start more ranks with mpi_tpu_torch.launcher "
            "instead)")
    nchildren = sum(n for _, n in segments)
    if nchildren < 1:
        raise ValueError("maxprocs must total >= 1")
    p = comm.size
    total = p + nchildren
    # root makes the rendezvous dirs; everyone learns them collectively
    if comm.rank == root:
        bridge_rdv = tempfile.mkdtemp(prefix=_PREFIX + "bridge_")
        child_rdv = tempfile.mkdtemp(prefix=_PREFIX + "world_")
        _bridge_dirs.append(bridge_rdv)
        _child_dirs.append(child_rdv)
        dirs = (bridge_rdv, child_rdv)
    else:
        dirs = None
    bridge_rdv, child_rdv = comm.bcast(dirs, root)
    # every parent opens its bridge endpoint BEFORE children are forked:
    # port files are published at once, connections form lazily
    union = _bridge_comm(comm.rank, total, bridge_rdv, comm.device)
    if comm.rank == root:
        child_rank = 0
        for argv, n in segments:
            for _ in range(n):
                # the parent's environment, MPI_TPU_DEVICE included: with
                # it unset each child takes card child_rank % count
                env = dict(os.environ)
                env.update({
                    ENV_RANK: str(child_rank),
                    ENV_SIZE: str(nchildren),
                    ENV_RDV: child_rdv,
                    ENV_BACKEND: "socket",
                    ENV_PARENT_RDV: bridge_rdv,
                    ENV_PARENT_SIZE: str(p),
                    ENV_PARENT_TOTAL: str(total),
                })
                # children import the package this parent runs, wherever
                # their script lives (as the launcher's ranks do)
                env["PYTHONPATH"] = os.pathsep.join(
                    x for x in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if x)
                if env_extra:
                    env.update(env_extra)
                _spawned.append(
                    subprocess.Popen([sys.executable, *argv], env=env))
                child_rank += 1
    return InterComm(union, list(range(p)), list(range(p, total)))


def comm_get_parent() -> Optional[InterComm]:
    """MPI_Comm_get_parent: in a spawned child, the intercomm to the
    spawning parents (cached); None in a world that was not spawned."""
    global _parent_intercomm
    if _parent_intercomm is not None:
        return _parent_intercomm
    rdv = os.environ.get(ENV_PARENT_RDV)
    if rdv is None:
        return None
    from . import init

    world = init()  # the child world: rank/size from the launcher-style env
    psize = int(os.environ[ENV_PARENT_SIZE])
    total = int(os.environ[ENV_PARENT_TOTAL])
    union = _bridge_comm(psize + world.rank, total, rdv, world.device)
    _parent_intercomm = InterComm(union, list(range(psize, total)),
                                  list(range(psize)))
    return _parent_intercomm


# -- establishing communication between independent jobs --------------------
# (MPI-2 ch.5.4: MPI_Open_port / MPI_Comm_accept / MPI_Comm_connect [S];
# the reference's protocol, mpi_tpu/spawn.py:181-199)
#
#   connect root:  writes  connect.<uuid>.json  {size: B, reply_dir: D}
#                  (D is a CLIENT-owned tempdir, so a server's close_port
#                  right after accept() cannot delete the reply unread)
#   accept root:   CLAIMS one request by atomic rename to claimed.<uuid>,
#                  makes a fresh bridge rdv dir, writes D/accept.json
#                  {size: A, rdv: <bridge dir>}
#   connect root:  polls D/accept.json, then removes D
#
# Both sides then build the bridge world (acceptors 0..A-1, connectors
# A..A+B-1) over the per-round rdv; each round has its own, so a port is
# reusable and close_port after establishment is safe.


def open_port() -> str:
    """MPI_Open_port: a name another, independently started job can connect
    to — a rendezvous directory, passed out of band (argv, env, a file, the
    name service).  Not auto-deleted: it lives until :func:`close_port`."""
    return tempfile.mkdtemp(prefix=_PREFIX + "port_")


def close_port(port_name: str) -> None:
    """MPI_Close_port.  Safe after accept/connect returned: each round's
    bridge uses its own rendezvous dir, not the port dir."""
    shutil.rmtree(port_name, ignore_errors=True)


def _publish(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)  # atomic publish


def _poll_for(fn, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got is not None:
            return got
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"no peer {what} within {timeout}s (is the other side "
                f"running?)")
        time.sleep(0.02)


def _root_exchange(comm, root: int, fn):
    """Run ``fn`` at root and broadcast (outcome, value), so a root failure
    raises on EVERY rank instead of leaving peers in the bcast."""
    if comm.rank == root:
        try:
            result = ("ok", fn())
        except Exception as e:  # noqa: BLE001 - re-raised everywhere below
            result = ("err", f"{type(e).__name__}: {e}")
    else:
        result = None
    kind, value = comm.bcast(result, root)
    if kind == "err":
        raise TimeoutError(f"port handshake failed at root: {value}")
    return value


def comm_accept(port_name: str, comm: Optional[Communicator] = None,
                root: int = 0, timeout: float = 120.0) -> InterComm:
    """MPI_Comm_accept: collective over the server job's ``comm``; blocks
    until a client job calls :func:`comm_connect` on the same port, then
    returns the intercommunicator (clients are the remote group).
    Reusable: call it again on the same port for the next client."""
    comm = _require_process_comm(comm, "comm_accept")

    def handshake():
        def try_claim():
            for name in sorted(os.listdir(port_name)):
                if name.startswith("connect.") and name.endswith(".json"):
                    token = name[len("connect."):-len(".json")]
                    claimed = os.path.join(port_name, f"claimed.{token}")
                    try:
                        os.rename(os.path.join(port_name, name), claimed)
                    except OSError:
                        continue  # another round won the race
                    with open(claimed) as f:
                        meta = json.load(f)
                    os.unlink(claimed)
                    # publish INSIDE the claim step: a timed-out client's
                    # stale request (its reply dir gone) is skipped, not
                    # allowed to poison the port for live clients
                    rdv = tempfile.mkdtemp(prefix=_PREFIX + "accept_")
                    try:
                        _publish(os.path.join(meta["reply_dir"],
                                              "accept.json"),
                                 {"size": comm.size, "rdv": rdv})
                    except OSError:
                        shutil.rmtree(rdv, ignore_errors=True)
                        continue  # dead requester; keep scanning
                    _bridge_dirs.append(rdv)
                    return int(meta["size"]), rdv
            return None

        return _poll_for(try_claim, timeout,
                         f"connected to port {port_name!r}")

    remote, rdv = _root_exchange(comm, root, handshake)
    total = comm.size + remote
    union = _bridge_comm(comm.rank, total, rdv, comm.device)
    return InterComm(union, list(range(comm.size)),
                     list(range(comm.size, total)))


def comm_connect(port_name: str, comm: Optional[Communicator] = None,
                 root: int = 0, timeout: float = 120.0) -> InterComm:
    """MPI_Comm_connect: the client side of :func:`comm_accept`."""
    comm = _require_process_comm(comm, "comm_connect")

    def handshake():
        token = uuid.uuid4().hex
        reply_dir = tempfile.mkdtemp(prefix=_PREFIX + "reply_")
        _publish(os.path.join(port_name, f"connect.{token}.json"),
                 {"size": comm.size, "reply_dir": reply_dir})
        reply = os.path.join(reply_dir, "accept.json")

        def read_reply():
            try:
                with open(reply) as f:
                    meta = json.load(f)
                return int(meta["size"]), meta["rdv"]
            except (OSError, ValueError, KeyError):
                return None

        try:
            return _poll_for(read_reply, timeout,
                             f"accepted at port {port_name!r}")
        finally:
            shutil.rmtree(reply_dir, ignore_errors=True)

    accept_size, rdv = _root_exchange(comm, root, handshake)
    total = accept_size + comm.size
    union = _bridge_comm(accept_size + comm.rank, total, rdv, comm.device)
    return InterComm(union, list(range(accept_size, total)),
                     list(range(accept_size)))


def _require_process_comm(comm, what: str) -> P2PCommunicator:
    if comm is None:
        from . import init

        comm = init()
    if not isinstance(comm, P2PCommunicator):
        raise NotImplementedError(
            f"{what} is a process-backend feature (it binds OS sockets); "
            "SPMD worlds cannot establish socket connections")
    return comm


# -- name service (MPI_Publish_name / MPI_Lookup_name [S: MPI-2 ch.5.4.4]) --
# A registry directory maps service names to port strings.  Default: a
# fixed per-user dir under the system tempdir; MPI_TPU_NAMESERVICE names
# another (a cluster-shared filesystem, a job's own directory).

ENV_NAMESERVICE = "MPI_TPU_NAMESERVICE"


def _name_dir() -> str:
    d = os.environ.get(ENV_NAMESERVICE)
    if d is None:
        d = os.path.join(tempfile.gettempdir(), f"mtt_names_{os.getuid()}")
    os.makedirs(d, mode=0o700, exist_ok=True)
    # the ssh-agent pattern: a directory (or a planted SYMLINK — lstat)
    # another user created could spoof published ports, so require a real
    # directory we own with no group/other write
    st = os.lstat(d)
    if not stat.S_ISDIR(st.st_mode) or st.st_uid != os.getuid() \
            or (st.st_mode & 0o022):
        raise PermissionError(
            f"name-service registry {d!r} is not a directory owned by "
            f"uid {os.getuid()} with mode 0700 — refusing (set "
            f"{ENV_NAMESERVICE} to a trusted directory)")
    return d


def _name_path(service_name: str) -> str:
    if "/" in service_name or service_name.startswith("."):
        raise ValueError(f"service names must be plain tokens, got "
                         f"{service_name!r}")
    return os.path.join(_name_dir(), service_name)


def publish_name(service_name: str, port_name: str) -> None:
    """MPI_Publish_name: make ``port_name`` discoverable as
    ``service_name`` (atomic; re-publishing overwrites)."""
    path = _name_path(service_name)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(port_name)
    os.replace(tmp, path)


def unpublish_name(service_name: str) -> None:
    """MPI_Unpublish_name."""
    try:
        os.unlink(_name_path(service_name))
    except FileNotFoundError:
        pass


def lookup_name(service_name: str, timeout: float = 0.0) -> str:
    """MPI_Lookup_name: the port published under ``service_name``;
    ``timeout > 0`` waits for it to appear (the client-starts-first race)."""
    path = _name_path(service_name)

    def read():
        try:
            with open(path) as f:
                return f.read().strip() or None
        except OSError:
            return None

    if timeout <= 0:
        got = read()
        if got is None:
            raise LookupError(f"no service published under "
                              f"{service_name!r} (registry: {_name_dir()})")
        return got
    return _poll_for(read, timeout, f"published service {service_name!r}")
