"""Replicated namespace store under the federation fabric — the port's
own copy of ``mpi_tpu/federation_store.py``: ``store_gauge`` and
``install_store_partition`` (:121, :130), the :class:`NamespaceStore`
contract and :class:`Watcher` (:144, :201), :class:`FileStore`
(:252-452), the frame helpers and ``_PeerLink`` (:454-555),
:class:`RaftNode` (:571-1202), :class:`RaftStore`,
:class:`RaftClientStore` and the client cache (:1209-1411), and the spec
resolution (:1413-1471).  It imports the standard library and the port's
``mpit``, ``resilience``, ``telemetry``, ``errors`` and socket transport
only: no tensor ever enters the store (node frames carry dicts).

A federation namespace is a pluggable :class:`NamespaceStore` (get / put
/ compare-and-swap / scan / watch, plus the append-only interval logs the
split-brain assertion reads), with two backends:

* :class:`FileStore` — a shared directory with ATOMIC CAS.  Each key's
  state lives in versioned files ``<key>.v<N>.json``; a write publishes
  a fully-written temp file onto ``<key>.v<N+1>.json`` with ``os.link``
  (create-exclusive: it FAILS instead of overwriting), so the version
  slot itself is the arbiter.  Two racing writers both target the SAME
  slot and exactly one link succeeds; a holder frozen (SIGSTOP) between
  its read and its publish loses the slot to the takeover and its
  thawed publish fails with EEXIST.  Deletes publish a tombstone version
  (same arbitration); readers take the highest parseable version.  The
  files are the reference's, byte for byte, for the same operations.

* :class:`RaftStore` — N store nodes (one embedded in each federation
  server) running a Raft-shaped consensus (Ongaro & Ousterhout 2014):
  terms, randomized election timeouts, majority-vote leader election
  with the log up-to-date check, an append-only replicated log with
  quorum-acked commit, conflict truncation, and snapshot compaction.
  Every mutation is a log command applied DETERMINISTICALLY on every
  node (a CAS is decided at apply time; the new version IS the log
  index), with an applied-nonce table making client retries
  exactly-once.  Node links ride the resilience primitives
  (``retry_connect`` + jittered ``backoff_delays``) with monotone
  per-peer sequence stamping (a receiver drops seq regressions, so a
  reconnect's overlap window cannot re-deliver); loss across
  reconnects is healed by Raft's own heartbeat retransmission, and
  duplication is idempotent by term/index checks plus the nonce table.

Partition semantics (the Chubby-shaped degradation): a node that
cannot commit (minority side, or no elected leader) raises the NAMED
:class:`~mpi_tpu_torch.errors.NoQuorumError` from every mutation, and
reports ``healthy() == False`` — which is what makes the federation
tier refuse leader authority and fail client admissions on the
minority side while the majority keeps serving.  Reads are served
from local applied state, stale-but-honest (endpoint discovery must
keep working on both sides so orphans re-converge after heal).

Fault injection: :meth:`RaftNode.install_partition` installs a
``{node_id: group}`` map into the LIVE store — node-to-node messages
crossing groups are dropped on both send and receive
(``store_partition_dropped`` pvar + trace instants); control-RPC
connections are exempt (they model the operator's out-of-band console,
from which a partition is installed and healed from outside).
``MPI_TPU_STORE_CHAOS=1`` additionally exposes partition install/heal +
node stats over the store's RPC port for subprocess fabrics.

Knobs (environment, read at import, the reference's defaults):
``MPI_TPU_STORE_ELECT_S`` (0.6), ``MPI_TPU_STORE_PROPOSE_S``
(max(2, 4 x elect)), ``MPI_TPU_STORE_SNAP_N`` (256).

Deliberate non-goals: static membership (no joint-consensus
reconfiguration), no durable raft state across a node restart (a
SIGKILLed server's store node does not rejoin the group in-term),
interval logs are compacted into snapshots whole (memory grows with
reign churn), and wall-clock lease stamps assume NTP-grade skew between
real hosts.
"""

from __future__ import annotations

import json
import os
import pickle
import queue
import random
import re
import socket
import struct
import threading
import time
import uuid
import weakref
from collections import deque, namedtuple
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import mpit as _mpit
from . import resilience as _resilience
from . import telemetry as _telemetry
from .errors import NoQuorumError
from .transport.socket import _recv_exact

__all__ = [
    "Rec", "NamespaceStore", "FileStore", "RaftNode", "RaftStore",
    "RaftClientStore", "Watcher", "NoQuorumError",
    "resolve_store", "resolve_member_store", "client_spec",
    "parse_member_spec", "install_store_partition", "store_gauge",
]

#: One committed record: ``value`` (a JSON-able dict), ``ver`` (the CAS
#: token — FileStore: the version-slot number; RaftStore: the log index
#: of the committing command) and ``stamp`` (writer wall time, what
#: lease staleness is judged from).
Rec = namedtuple("Rec", ("value", "ver", "stamp"))

_FRAME = struct.Struct("!I")

# Raft timing (seconds).  Election timeout is randomized in
# [T, 2T); heartbeats at T/4.  Defaults keep elections well under the
# federation lease bound (2-3s in the chaos legs) while staying lazy
# enough for a loaded 2-core CI box; override per-fabric via env.
_ELECT_S = float(os.environ.get("MPI_TPU_STORE_ELECT_S", "0.6"))
_PROPOSE_TIMEOUT_S = float(os.environ.get(
    "MPI_TPU_STORE_PROPOSE_S", str(max(2.0, 4 * _ELECT_S))))
# log length that triggers snapshot compaction (small enough that the
# committed chaos artifact proves compaction fired mid-run)
_SNAP_THRESHOLD = int(os.environ.get("MPI_TPU_STORE_SNAP_N", "256"))
_WATCH_POLL_S = 0.1
_TOMBSTONE_GC_S = 60.0

# live RaftNodes in this process (the store_term / store_commit_index
# gauge pvars in mpit.py read the max over these)
_NODES: "weakref.WeakSet[RaftNode]" = weakref.WeakSet()


def store_gauge(field: str) -> int:
    """Max of ``field`` over this process's live store nodes (gauge
    pvar hook — 0 with no node, so the off-mode pvar contract holds)."""
    best = 0
    for node in list(_NODES):
        best = max(best, int(getattr(node, field, 0)))
    return best


def install_store_partition(mapping: Optional[Dict[int, int]]) -> int:
    """Install (or heal, with None) a partition map into every live
    store node of THIS process — the ``install_link_faults`` idiom at
    the store tier.  Returns the number of nodes updated."""
    n = 0
    for node in list(_NODES):
        node.install_partition(mapping)
        n += 1
    return n


# -- the interface ------------------------------------------------------------


class NamespaceStore:
    """What the federation tier needs from a namespace: a small
    versioned KV with atomic compare-and-swap (the lease primitive),
    prefix scan/watch (endpoint + ownership records), and per-key
    append-only logs (the leader authority intervals).  ``ver`` tokens
    are opaque ints: pass a read's ``ver`` back to :meth:`cas`;
    ``expect_ver=None`` means "only if absent" (the O_EXCL-create
    shape).  Implementations raise :class:`NoQuorumError` from
    mutations they cannot commit — callers treat that as "authority
    refused", never as success or plain failure."""

    def get(self, key: str) -> Optional[Rec]:
        raise NotImplementedError

    def cas(self, key: str, expect_ver: Optional[int],
            value: dict) -> Optional[Rec]:
        """Atomic: write ``value`` iff the key's current version is
        ``expect_ver`` (None = absent).  Returns the new Rec, or None
        on a lost race / stale expectation."""
        raise NotImplementedError

    def put(self, key: str, value: dict) -> Rec:
        """Unconditional upsert (bounded internal CAS retry)."""
        for _ in range(64):
            cur = self.get(key)
            rec = self.cas(key, None if cur is None else cur.ver, value)
            if rec is not None:
                return rec
        raise OSError(f"store put({key!r}): persistent CAS contention")

    def delete(self, key: str, expect_ver: Optional[int] = None) -> bool:
        raise NotImplementedError

    def scan(self, prefix: str) -> Dict[str, Rec]:
        raise NotImplementedError

    def append(self, key: str, record: dict) -> None:
        raise NotImplementedError

    def log_scan(self, prefix: str) -> Dict[str, List[dict]]:
        raise NotImplementedError

    def watch(self, prefix: str) -> "Watcher":
        return Watcher(lambda: self.scan(prefix))

    def healthy(self) -> bool:
        """Can a mutation commit right now?  FileStore: always (the
        directory IS the quorum); RaftStore: quorum reachability."""
        return True

    def describe(self) -> str:
        return type(self).__name__

    def close(self) -> None:
        pass


class Watcher:
    """Polling change feed over a prefix scan: a daemon thread diffs
    versions each ``_WATCH_POLL_S`` and queues ``(key, rec_or_None)``
    events (None = deleted).  Uniform across backends — RaftStore
    local state and FileStore directories poll equally well at
    federation cadences."""

    def __init__(self, poll: Callable[[], Dict[str, Rec]],
                 interval: float = _WATCH_POLL_S) -> None:
        self._poll = poll
        self._interval = interval
        self._events: "queue.Queue[Tuple[str, Optional[Rec]]]" = \
            queue.Queue()
        self._stop = threading.Event()
        self._seen: Dict[str, int] = {k: r.ver
                                      for k, r in poll().items()}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="store-watch")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                cur = self._poll()
            except (OSError, NoQuorumError):
                continue  # store tearing down / partitioned: re-poll
            for k, r in cur.items():
                if self._seen.get(k) != r.ver:
                    self._seen[k] = r.ver
                    self._events.put((k, r))
            for k in [k for k in self._seen if k not in cur]:
                del self._seen[k]
                self._events.put((k, None))

    def next(self, timeout: Optional[float] = None
             ) -> Optional[Tuple[str, Optional[Rec]]]:
        try:
            return self._events.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._stop.set()


# -- file backend -------------------------------------------------------------


_VER_RE = re.compile(r"^(?P<key>.+)\.v(?P<ver>\d+)\.json$")


class FileStore(NamespaceStore):
    """The namespace directory, with ATOMIC CAS (see module docstring
    for the version-slot arbitration that closes the leader-lease
    takeover race).  Stateless per instance — any number of
    processes/handles on one directory compose; the directory is the
    shared truth."""

    #: test seam (SIGSTOP-in-the-window regression): called between the
    #: current-version read and the publish link of every cas()
    _test_mid_cas: Optional[Callable[[str], None]] = None

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- internals --

    def _versions(self, names: List[str]) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for name in names:
            m = _VER_RE.match(name)
            if m:
                out.setdefault(m.group("key"), []).append(
                    int(m.group("ver")))
        for vers in out.values():
            vers.sort(reverse=True)
        return out

    def _names(self) -> List[str]:
        try:
            return os.listdir(self.root)
        except OSError:
            return []

    def _read_ver(self, key: str, ver: int) -> Optional[dict]:
        try:
            with open(os.path.join(self.root,
                                   f"{key}.v{ver}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None  # vanished (GC) or mid-write: caller falls back

    def _current(self, key: str,
                 vers: Optional[List[int]] = None
                 ) -> Tuple[Optional[dict], int]:
        """(wrapper, ver) of the highest parseable version; (None, 0)
        for a key with no versions at all.  A tombstone wrapper is
        returned as-is — callers distinguish deleted from absent."""
        if vers is None:
            vers = self._versions(self._names()).get(key, [])
        for v in vers:
            w = self._read_ver(key, v)
            if w is not None:
                return w, v
        return None, 0

    # -- interface --

    def get(self, key: str) -> Optional[Rec]:
        w, v = self._current(key)
        if w is None or w.get("dead"):
            return None
        return Rec(w.get("v"), v, float(w.get("stamp", 0.0)))

    def cas(self, key: str, expect_ver: Optional[int],
            value: Optional[dict], _dead: bool = False
            ) -> Optional[Rec]:
        vers = self._versions(self._names()).get(key, [])
        w, cur = self._current(key, vers)
        live = w is not None and not w.get("dead")
        if expect_ver is None:
            if live:
                return None
        elif not live or cur != expect_ver:
            return None
        if self._test_mid_cas is not None:
            self._test_mid_cas(key)
        # epoch check: the successor slot must top
        # EVERY existing slot NUMBER, not just the highest parseable
        # one — inside the tombstone-GC window a recreate can observe a
        # chain of truncated placeholders (cur == 0) whose names are
        # still on disk; cur + 1 would collide with (EEXIST) or recycle
        # one of them, handing a straggler frozen on the dead chain a
        # silent win over the recreated key
        new_ver = max(vers[0] if vers else 0, cur) + 1
        stamp = time.time()
        wrapper = {"v": value, "stamp": stamp}
        if _dead:
            wrapper["dead"] = True
        tmp = os.path.join(self.root,
                           f".tmp.{uuid.uuid4().hex}")
        final = os.path.join(self.root, f"{key}.v{new_ver}.json")
        with open(tmp, "w") as f:
            json.dump(wrapper, f)
        try:
            # the atomic arbitration: link() is create-exclusive — the
            # FIRST writer owns slot v<N+1>, every straggler (including
            # a SIGSTOP-thawed holder whose read predates the winner's
            # publish) gets EEXIST and reports the lost race
            os.link(tmp, final)
        except FileExistsError:
            return None
        except OSError:
            return None  # namespace tearing down
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        # superseded-version GC: keep one predecessor's CONTENT as the
        # readers' mid-publish fallback; older slots are truncated to
        # empty placeholders but NEVER unlinked — the slot NAME is the
        # arbitration token, and a recycled name would hand a straggler
        # frozen past two generations a silent win over a newer commit
        # (the lost-update variant of the takeover window).  The walk
        # stops at the first already-empty slot, so it is amortized
        # O(1); empty placeholders parse-fail in _read_ver and cost
        # readers nothing on the happy path.
        for v in range(new_ver - 2, 0, -1):
            p = os.path.join(self.root, f"{key}.v{v}.json")
            try:
                if os.path.getsize(p) == 0:
                    break
                os.truncate(p, 0)
            except OSError:
                break
        return Rec(value, new_ver, stamp)

    def delete(self, key: str, expect_ver: Optional[int] = None) -> bool:
        for _ in range(64):
            w, cur = self._current(key)
            live = w is not None and not w.get("dead")
            if not live:
                return expect_ver is None  # already gone
            if expect_ver is not None and cur != expect_ver:
                return False
            if self.cas(key, cur, None, _dead=True) is not None:
                return True
            if expect_ver is not None:
                return False
        return False

    def scan(self, prefix: str) -> Dict[str, Rec]:
        names = self._names()
        out: Dict[str, Rec] = {}
        now = time.time()
        for key, vers in self._versions(names).items():
            if not key.startswith(prefix):
                continue
            w, v = self._current(key, vers)
            if w is None:
                continue
            if w.get("dead"):
                # opportunistic tombstone GC: a long-dead key's version
                # chain is garbage once every reader has moved on
                if now - float(w.get("stamp", now)) > _TOMBSTONE_GC_S:
                    # unlink ASCENDING so the tombstone (the highest
                    # slot) goes LAST: a GC interrupted mid-chain
                    # leaves the key still visibly dead — removing the
                    # tombstone first would resurrect the stale
                    # predecessor value for every reader racing the
                    # delete/recreate window
                    for vv in reversed(vers):
                        try:
                            os.unlink(os.path.join(
                                self.root, f"{key}.v{vv}.json"))
                        except OSError:
                            pass
                continue
            out[key] = Rec(w.get("v"), v, float(w.get("stamp", 0.0)))
        return out

    def append(self, key: str, record: dict) -> None:
        # one writer per log key (leader.log.<id>) + O_APPEND: the
        # same appender contract the interval logs rely on
        with open(os.path.join(self.root, key), "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_scan(self, prefix: str) -> Dict[str, List[dict]]:
        out: Dict[str, List[dict]] = {}
        for name in self._names():
            if not name.startswith(prefix) or _VER_RE.match(name) \
                    or name.startswith(".tmp."):
                continue
            entries: List[dict] = []
            try:
                with open(os.path.join(self.root, name)) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            entries.append(json.loads(line))
            except (OSError, ValueError):
                continue
            out[name] = entries
        return out

    def describe(self) -> str:
        return self.root


# -- raft backend -------------------------------------------------------------


def _send_frame(sock: socket.socket, lock: Optional[threading.Lock],
                msg: dict) -> None:
    blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    frame = _FRAME.pack(len(blob)) + blob
    if lock is None:
        sock.sendall(frame)
    else:
        with lock:
            sock.sendall(frame)


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    head = _recv_exact(sock, _FRAME.size)
    if head is None:
        return None
    (n,) = _FRAME.unpack(head)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return pickle.loads(body)


class _PeerLink:
    """Outbound half of one node→peer link: a bounded queue drained by
    a daemon thread that (re)dials with the resilience
    primitives and stamps a per-peer monotone ``seq`` on every frame
    (never reset across reconnects, so the receiver's monotone filter
    dedups any reconnect-overlap delivery).  Send-side losses are NOT
    retransmitted here — Raft's heartbeat cycle is the retransmission
    layer; this link only guarantees ordering and no-duplication."""

    def __init__(self, me: int, peer: int, addr: str) -> None:
        self.me, self.peer, self.addr = me, peer, addr
        self._q: "deque[dict]" = deque(maxlen=256)
        self._has = threading.Event()
        self._stop = threading.Event()
        self._seq = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"store-link-{me}->{peer}")
        self._thread.start()

    def send(self, msg: dict) -> None:
        with self._lock:
            self._seq += 1
            self._q.append({**msg, "seq": self._seq, "from": self.me})
        self._has.set()

    def _loop(self) -> None:
        sock: Optional[socket.socket] = None
        while not self._stop.is_set():
            if not self._has.wait(timeout=0.5):
                continue
            if sock is None:
                host, _, port = self.addr.rpartition(":")
                try:
                    sock = _resilience.retry_connect(
                        lambda: socket.create_connection(
                            (host, int(port)), timeout=2.0),
                        timeout_s=2.0)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    _send_frame(sock, None, {"t": "peer",
                                             "from": self.me})
                except OSError:
                    sock = None
                    # peer down: drop what queued (raft re-offers on
                    # its heartbeat cadence) and back off one beat
                    with self._lock:
                        self._q.clear()
                        self._has.clear()
                    self._stop.wait(0.25)
                    continue
            while True:
                with self._lock:
                    if not self._q:
                        self._has.clear()
                        break
                    msg = self._q.popleft()
                try:
                    _send_frame(sock, None, msg)
                except OSError:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
                    break
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        self._has.set()


class _Future:
    __slots__ = ("_ev", "_res")

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._res: Any = None

    def set(self, res: Any) -> None:
        self._res = res
        self._ev.set()

    def wait(self, timeout: float) -> Optional[Any]:
        return self._res if self._ev.wait(timeout) else None


class RaftNode:
    """One member of the replicated store group (see module docstring
    for scope and the honest non-goals).  All state is guarded by one
    RLock; message handling never blocks on the network (sends go
    through :class:`_PeerLink` queues)."""

    def __init__(self, node_id: int, addrs: List[str],
                 elect_timeout_s: float = _ELECT_S,
                 snap_threshold: int = _SNAP_THRESHOLD) -> None:
        if not (0 <= node_id < len(addrs)):
            raise ValueError(
                f"store node id {node_id} outside addrs[{len(addrs)}]")
        self.nid = node_id
        self.addrs = list(addrs)
        self.n = len(addrs)
        self.majority = self.n // 2 + 1
        self._elect_s = float(elect_timeout_s)
        self._snap_threshold = int(snap_threshold)
        self._lock = threading.RLock()
        self._rng = random.Random(0x5710 + node_id)
        # raft state (volatile: no durable term/vote — restart = fresh
        # identity, a documented non-goal)
        self.term = 0
        self.voted_for: Optional[int] = None
        self.role = "follower"
        self.leader_id: Optional[int] = None
        self.log: List[dict] = []          # {"term": t, "cmd": {...}}
        self.base_index = 0                # last snapshot-covered index
        self.base_term = 0
        self.commit_index = 0
        self.applied_index = 0
        self._votes: set = set()
        self._next: Dict[int, int] = {}
        self._match: Dict[int, int] = {}
        # state machine
        self.kv: Dict[str, Tuple[Any, int, float]] = {}
        self.logs: Dict[str, List[dict]] = {}
        self._nonces: Dict[str, Any] = {}
        self._nonce_order: deque = deque()
        self._pending: Dict[str, _Future] = {}
        # liveness bookkeeping
        now = time.monotonic()
        self._last_heard = now
        self._last_ack: Dict[int, float] = {}
        self._deadline = now + self._rand_elect()
        self._last_hb = 0.0
        # fault injection + evidence counters
        self._partition: Optional[Dict[int, int]] = None
        self.elections = 0
        self.truncated_entries = 0
        self.snapshots = 0
        self.partition_dropped = 0
        self._rx_seq: Dict[int, int] = {}
        # wiring
        host, _, port = self.addrs[node_id].rpartition(":")
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(16)
        if int(port) == 0:
            a = self._listener.getsockname()
            self.addrs[node_id] = "%s:%d" % (a[0], a[1])
        self._stop = threading.Event()
        self._peers = {p: _PeerLink(node_id, p, self.addrs[p])
                       for p in range(self.n) if p != node_id}
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"store-accept-{node_id}"),
            threading.Thread(target=self._timer_loop, daemon=True,
                             name=f"store-timer-{node_id}"),
        ]
        for t in self._threads:
            t.start()
        _NODES.add(self)

    # -- helpers --

    def _rand_elect(self) -> float:
        return self._elect_s * (1.0 + self._rng.random())

    @property
    def addr(self) -> str:
        return self.addrs[self.nid]

    def _last_index(self) -> int:
        return self.base_index + len(self.log)

    def _term_at(self, idx: int) -> int:
        if idx == self.base_index:
            return self.base_term
        return self.log[idx - self.base_index - 1]["term"]

    def _entry(self, idx: int) -> dict:
        return self.log[idx - self.base_index - 1]

    def _blocked(self, peer: int) -> bool:
        p = self._partition
        if p is None:
            return False
        return p.get(self.nid) != p.get(peer)

    def install_partition(self,
                          mapping: Optional[Dict[int, int]]) -> None:
        """Install/heal the partition map (None heals).  Takes effect
        on the next frame in either direction — live injection."""
        with self._lock:
            self._partition = dict(mapping) if mapping else None
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("store", "partition_installed",
                     attrs={"node": self.nid,
                            "map": mapping or "healed"})

    def _send(self, peer: int, msg: dict) -> None:
        if self._blocked(peer):
            self.partition_dropped += 1
            _mpit.count(store_partition_dropped=1)
            return
        self._peers[peer].send(msg)

    def _broadcast(self, msg: dict) -> None:
        for p in self._peers:
            self._send(p, msg)

    # -- inbound --

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True,
                             name=f"store-conn-{self.nid}").start()

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            first = _recv_frame(conn)
            if first is None:
                return
            if first.get("t") == "peer":
                peer = int(first["from"])
                while True:
                    msg = _recv_frame(conn)
                    if msg is None:
                        return
                    self._on_peer_msg(peer, msg)
            else:
                # client RPC connection: request/reply, pipelined
                msg: Optional[dict] = first
                lock = threading.Lock()
                while msg is not None:
                    reply = self._rpc(msg)
                    try:
                        _send_frame(conn, lock, reply)
                    except OSError:
                        return
                    msg = _recv_frame(conn)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _on_peer_msg(self, peer: int, msg: dict) -> None:
        with self._lock:
            if self._blocked(peer):
                # inbound half of the injection: frames already in
                # flight when the map landed must not leak through
                self.partition_dropped += 1
                _mpit.count(store_partition_dropped=1)
                return
            seq = int(msg.get("seq", 0))
            if seq and seq <= self._rx_seq.get(peer, 0):
                return  # reconnect-overlap duplicate: sequenced drop
            if seq:
                self._rx_seq[peer] = seq
            t = msg.get("t")
            if t == "rv":
                self._on_request_vote(peer, msg)
            elif t == "rv_r":
                self._on_vote_reply(peer, msg)
            elif t == "ae":
                self._on_append_entries(peer, msg)
            elif t == "ae_r":
                self._on_append_reply(peer, msg)
            elif t == "snap":
                self._on_snapshot(peer, msg)
            elif t == "prop":
                self._on_propose_fwd(msg)

    # -- elections --

    def _step_down(self, term: int) -> None:
        self.term = term
        self.role = "follower"
        self.voted_for = None
        self._votes = set()
        self._deadline = time.monotonic() + self._rand_elect()

    def _timer_loop(self) -> None:
        while not self._stop.wait(0.05):
            with self._lock:
                now = time.monotonic()
                if self.role == "leader":
                    if now - self._last_hb >= self._elect_s / 4:
                        self._last_hb = now
                        for p in self._peers:
                            self._send_ae(p)
                elif now >= self._deadline:
                    self._start_election()
                self._maybe_snapshot()

    def _start_election(self) -> None:
        self.term += 1
        self.role = "candidate"
        self.voted_for = self.nid
        self._votes = {self.nid}
        self.leader_id = None
        self.elections += 1
        self._deadline = time.monotonic() + self._rand_elect()
        _mpit.count(store_elections=1)
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("store", "election_started",
                     attrs={"node": self.nid, "term": self.term})
        if self.n == 1:
            self._become_leader()
            return
        self._broadcast({"t": "rv", "term": self.term,
                         "cand": self.nid,
                         "lli": self._last_index(),
                         "llt": self._term_at(self._last_index())})

    def _on_request_vote(self, peer: int, msg: dict) -> None:
        if msg["term"] > self.term:
            self._step_down(msg["term"])
        granted = False
        if msg["term"] == self.term \
                and self.voted_for in (None, msg["cand"]):
            # the up-to-date check: never elect a leader whose log
            # would discard committed entries
            my_lli = self._last_index()
            my_llt = self._term_at(my_lli)
            if (msg["llt"], msg["lli"]) >= (my_llt, my_lli):
                granted = True
                self.voted_for = msg["cand"]
                self._deadline = time.monotonic() + self._rand_elect()
        self._send(peer, {"t": "rv_r", "term": self.term,
                          "granted": granted})

    def _on_vote_reply(self, peer: int, msg: dict) -> None:
        if msg["term"] > self.term:
            self._step_down(msg["term"])
            return
        if self.role != "candidate" or msg["term"] != self.term:
            return
        if msg.get("granted"):
            self._votes.add(peer)
            if len(self._votes) >= self.majority:
                self._become_leader()

    def _become_leader(self) -> None:
        self.role = "leader"
        self.leader_id = self.nid
        last = self._last_index()
        self._next = {p: last + 1 for p in self._peers}
        self._match = {p: 0 for p in self._peers}
        self._last_ack = {}
        self._last_hb = time.monotonic()
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("store", "leader_elected",
                     attrs={"node": self.nid, "term": self.term})
        for p in self._peers:
            self._send_ae(p)
        self._advance_commit()

    # -- replication --

    def _send_ae(self, peer: int) -> None:
        ni = self._next.get(peer, self._last_index() + 1)
        if ni <= self.base_index:
            self._send(peer, {"t": "snap", "term": self.term,
                              "lead": self.nid,
                              "idx": self.base_index,
                              "sterm": self.base_term,
                              "kv": dict(self.kv),
                              "logs": {k: list(v) for k, v
                                       in self.logs.items()},
                              "nonces": dict(self._nonces)})
            return
        prev = ni - 1
        entries = self.log[prev - self.base_index:
                           prev - self.base_index + 64]
        self._send(peer, {"t": "ae", "term": self.term,
                          "lead": self.nid, "pli": prev,
                          "plt": self._term_at(prev),
                          "ent": entries, "ci": self.commit_index})

    def _on_append_entries(self, peer: int, msg: dict) -> None:
        if msg["term"] < self.term:
            self._send(peer, {"t": "ae_r", "term": self.term,
                              "ok": False, "match": 0,
                              "hint": self._last_index()})
            return
        if msg["term"] > self.term or self.role != "follower":
            self._step_down(msg["term"])
        self.leader_id = msg["lead"]
        self._last_heard = time.monotonic()
        self._deadline = self._last_heard + self._rand_elect()
        pli, plt = int(msg["pli"]), int(msg["plt"])
        if pli < self.base_index or pli > self._last_index() \
                or self._term_at(pli) != plt:
            self._send(peer, {"t": "ae_r", "term": self.term,
                              "ok": False, "match": 0,
                              "hint": min(self._last_index(),
                                          max(self.base_index, pli))})
            return
        idx = pli
        for ent in msg["ent"]:
            idx += 1
            if idx <= self._last_index():
                if self._term_at(idx) == ent["term"]:
                    continue
                # conflict: truncate OUR uncommitted suffix — these
                # are the minority's stale intents being discarded
                dropped = self._last_index() - idx + 1
                del self.log[idx - self.base_index - 1:]
                self.truncated_entries += dropped
                _mpit.count(store_entries_truncated=dropped)
                rec = _telemetry.REC
                if rec is not None:
                    rec.emit("store", "log_truncated",
                             attrs={"node": self.nid, "at": idx,
                                    "dropped": dropped})
            self.log.append(ent)
        self.commit_index = max(self.commit_index,
                                min(int(msg["ci"]), self._last_index()))
        self._apply_ready()
        self._send(peer, {"t": "ae_r", "term": self.term, "ok": True,
                          "match": idx})

    def _on_append_reply(self, peer: int, msg: dict) -> None:
        if msg["term"] > self.term:
            self._step_down(msg["term"])
            return
        if self.role != "leader":
            return
        self._last_ack[peer] = time.monotonic()
        if msg.get("ok"):
            self._match[peer] = max(self._match.get(peer, 0),
                                    int(msg["match"]))
            self._next[peer] = self._match[peer] + 1
            if self._next[peer] <= self._last_index():
                self._send_ae(peer)  # keep streaming the backlog
            self._advance_commit()
        else:
            hint = int(msg.get("hint", 0))
            self._next[peer] = max(self.base_index,
                                   min(self._next.get(peer, 1) - 1,
                                       hint + 1))
            self._send_ae(peer)

    def _advance_commit(self) -> None:
        for idx in range(self._last_index(), self.commit_index, -1):
            if self._term_at(idx) != self.term:
                break  # only own-term entries commit by counting [Raft §5.4.2]
            acks = 1 + sum(1 for p in self._peers
                           if self._match.get(p, 0) >= idx)
            if acks >= self.majority:
                self.commit_index = idx
                self._apply_ready()
                break

    def _on_snapshot(self, peer: int, msg: dict) -> None:
        if msg["term"] < self.term:
            return
        if msg["term"] > self.term or self.role != "follower":
            self._step_down(msg["term"])
        self.leader_id = msg["lead"]
        self._last_heard = time.monotonic()
        self._deadline = self._last_heard + self._rand_elect()
        if int(msg["idx"]) <= self.base_index:
            return  # stale snapshot
        self.kv = dict(msg["kv"])
        self.logs = {k: list(v) for k, v in msg["logs"].items()}
        self._nonces = dict(msg["nonces"])
        self._nonce_order = deque(self._nonces)
        self.base_index = int(msg["idx"])
        self.base_term = int(msg["sterm"])
        self.log = []
        self.commit_index = max(self.commit_index, self.base_index)
        self.applied_index = self.base_index
        self._send(peer, {"t": "ae_r", "term": self.term, "ok": True,
                          "match": self.base_index})

    def _maybe_snapshot(self) -> None:
        if self.applied_index - self.base_index < self._snap_threshold:
            return
        drop = self.applied_index - self.base_index
        self.base_term = self._term_at(self.applied_index)
        del self.log[:drop]
        self.base_index = self.applied_index
        self.snapshots += 1
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("store", "snapshot_compacted",
                     attrs={"node": self.nid,
                            "through": self.base_index})

    # -- the state machine --

    def _apply_ready(self) -> None:
        while self.applied_index < self.commit_index:
            self.applied_index += 1
            ent = self._entry(self.applied_index)
            res = self._apply_cmd(ent["cmd"], self.applied_index)
            fut = self._pending.pop(ent["cmd"]["nonce"], None)
            if fut is not None:
                fut.set(res)

    def _apply_cmd(self, cmd: dict, idx: int) -> tuple:
        nonce = cmd["nonce"]
        if nonce in self._nonces:
            return self._nonces[nonce]  # exactly-once under retry
        op = cmd["op"]
        key = cmd.get("key")
        stamp = float(cmd.get("stamp", 0.0))
        cur = self.kv.get(key)
        if op == "cas":
            ev = cmd["ev"]
            if (ev is None) == (cur is None) \
                    and (cur is None or cur[1] == ev):
                self.kv[key] = (cmd["val"], idx, stamp)
                res = ("ok", idx, stamp)
            else:
                res = ("fail",)
        elif op == "put":
            self.kv[key] = (cmd["val"], idx, stamp)
            res = ("ok", idx, stamp)
        elif op == "del":
            ev = cmd["ev"]
            if cur is None:
                res = ("ok",) if ev is None else ("fail",)
            elif ev is None or cur[1] == ev:
                del self.kv[key]
                res = ("ok",)
            else:
                res = ("fail",)
        elif op == "append":
            self.logs.setdefault(key, []).append(cmd["rec"])
            res = ("ok",)
        else:
            res = ("fail",)
        self._nonces[nonce] = res
        self._nonce_order.append(nonce)
        while len(self._nonce_order) > 8192:
            self._nonces.pop(self._nonce_order.popleft(), None)
        return res

    # -- the write path --

    def propose(self, cmd: dict,
                timeout: float = _PROPOSE_TIMEOUT_S) -> tuple:
        """Commit one command through the group; returns the applied
        result.  Raises :class:`NoQuorumError` when no quorum commits
        it within ``timeout`` — the named minority verdict."""
        nonce = uuid.uuid4().hex
        cmd = {**cmd, "nonce": nonce, "stamp": time.time()}
        fut = _Future()
        deadline = time.monotonic() + timeout
        sent_to: Optional[Tuple[str, int]] = None
        last_send = 0.0
        with self._lock:
            self._pending[nonce] = fut
        try:
            while True:
                now = time.monotonic()
                with self._lock:
                    route = (("self", self.term)
                             if self.role == "leader"
                             else ("fwd%d" % self.leader_id, self.term)
                             if self.leader_id is not None
                             and self.leader_id != self.nid
                             else None)
                    if route is not None and (
                            route != sent_to or now - last_send > 0.6):
                        sent_to, last_send = route, now
                        if self.role == "leader":
                            self.log.append({"term": self.term,
                                             "cmd": cmd})
                            if self.n == 1:
                                self._advance_commit()
                            else:
                                for p in self._peers:
                                    self._send_ae(p)
                        else:
                            self._send(self.leader_id,
                                       {"t": "prop", "cmd": cmd})
                res = fut.wait(min(0.1, max(0.0, deadline - now)))
                if res is not None:
                    return res
                if time.monotonic() >= deadline:
                    raise NoQuorumError(
                        f"store node {self.nid}: no quorum committed "
                        f"the {cmd['op']}({cmd.get('key')!r}) within "
                        f"{timeout:.1f}s (role {self.role}, term "
                        f"{self.term}, leader {self.leader_id}) — "
                        f"minority side of a partition, or no elected "
                        f"store leader")
        finally:
            with self._lock:
                self._pending.pop(nonce, None)

    def _on_propose_fwd(self, msg: dict) -> None:
        cmd = msg["cmd"]
        if self.role == "leader":
            self.log.append({"term": self.term, "cmd": cmd})
            for p in self._peers:
                self._send_ae(p)
        elif self.leader_id is not None and self.leader_id != self.nid:
            self._send(self.leader_id, msg)  # one-hop re-forward

    # -- liveness / introspection --

    def healthy(self) -> bool:
        """Quorum reachability from THIS node: a leader with fresh
        majority acks, or a follower with fresh leader contact.  What
        the serve tier's admission fence and the LeaderLease consult —
        the minority side turns unhealthy within one election bound."""
        with self._lock:
            if self.n == 1:
                return True
            now = time.monotonic()
            window = 2.5 * self._elect_s
            if self.role == "leader":
                fresh = 1 + sum(1 for t in self._last_ack.values()
                                if now - t < window)
                return fresh >= self.majority
            return (self.leader_id is not None
                    and now - self._last_heard < window)

    def stats(self) -> dict:
        with self._lock:
            return {"node": self.nid, "addr": self.addr,
                    "role": self.role, "term": self.term,
                    "leader": self.leader_id,
                    "commit_index": self.commit_index,
                    "applied_index": self.applied_index,
                    "base_index": self.base_index,
                    "log_len": len(self.log),
                    "elections": self.elections,
                    "snapshots": self.snapshots,
                    "truncated_entries": self.truncated_entries,
                    "partition_dropped": self.partition_dropped,
                    "healthy": None,  # filled below, outside the lock
                    "keys": len(self.kv)}

    # -- client RPC --

    def _rpc(self, msg: dict) -> dict:
        t = msg.get("t")
        try:
            if t == "read":
                return self._rpc_read(msg)
            if t == "write":
                return self._rpc_write(msg)
            if t == "chaos":
                if os.environ.get("MPI_TPU_STORE_CHAOS") != "1":
                    return {"err": "ValueError",
                            "msg": "chaos RPC disabled "
                                   "(MPI_TPU_STORE_CHAOS != 1)"}
                return self._rpc_chaos(msg)
            return {"err": "ValueError", "msg": f"unknown rpc {t!r}"}
        except NoQuorumError as e:
            return {"err": "NoQuorumError", "msg": str(e)}
        except Exception as e:  # noqa: BLE001 - shipped to the client
            return {"err": type(e).__name__, "msg": str(e)[:300]}

    def _rpc_read(self, msg: dict) -> dict:
        op = msg["op"]
        with self._lock:
            if op == "get":
                return {"ok": True, "rec": self.kv.get(msg["key"])}
            if op == "scan":
                pre = msg["prefix"]
                return {"ok": True,
                        "recs": {k: v for k, v in self.kv.items()
                                 if k.startswith(pre)}}
            if op == "log_scan":
                pre = msg["prefix"]
                return {"ok": True,
                        "logs": {k: list(v)
                                 for k, v in self.logs.items()
                                 if k.startswith(pre)}}
            if op == "health":
                pass  # healthy() takes the lock itself, fall through
        if op == "health":
            return {"ok": True, "healthy": self.healthy()}
        return {"err": "ValueError", "msg": f"unknown read {op!r}"}

    def _rpc_write(self, msg: dict) -> dict:
        res = self.propose({k: msg[k] for k in
                            ("op", "key", "ev", "val", "rec")
                            if k in msg})
        return {"ok": True, "res": res}

    def _rpc_chaos(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "partition":
            self.install_partition(msg.get("map"))
            return {"ok": True}
        if op == "stats":
            st = self.stats()
            st["healthy"] = self.healthy()
            return {"ok": True, "stats": st}
        return {"err": "ValueError", "msg": f"unknown chaos {op!r}"}

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for link in self._peers.values():
            link.close()


def _rec_from_tuple(t: Optional[Tuple[Any, int, float]]
                    ) -> Optional[Rec]:
    return None if t is None else Rec(t[0], t[1], t[2])


class RaftStore(NamespaceStore):
    """Member-mode store handle: wraps this server's embedded
    :class:`RaftNode`.  Reads are local applied state (stale-ok);
    mutations are quorum commits that raise the named
    :class:`NoQuorumError` on the minority side."""

    def __init__(self, node: RaftNode, owns_node: bool = True) -> None:
        self.node = node
        self._owns = owns_node

    def get(self, key: str) -> Optional[Rec]:
        with self.node._lock:
            return _rec_from_tuple(self.node.kv.get(key))

    def cas(self, key: str, expect_ver: Optional[int],
            value: dict) -> Optional[Rec]:
        res = self.node.propose({"op": "cas", "key": key,
                                 "ev": expect_ver, "val": value})
        if res[0] != "ok":
            return None
        return Rec(value, res[1], res[2])

    def put(self, key: str, value: dict) -> Rec:
        res = self.node.propose({"op": "put", "key": key,
                                 "val": value})
        return Rec(value, res[1], res[2])

    def delete(self, key: str, expect_ver: Optional[int] = None) -> bool:
        res = self.node.propose({"op": "del", "key": key,
                                 "ev": expect_ver})
        return res[0] == "ok"

    def scan(self, prefix: str) -> Dict[str, Rec]:
        with self.node._lock:
            return {k: _rec_from_tuple(v)
                    for k, v in self.node.kv.items()
                    if k.startswith(prefix)}

    def append(self, key: str, record: dict) -> None:
        res = self.node.propose({"op": "append", "key": key,
                                 "rec": record})
        if res[0] != "ok":  # pragma: no cover - append never CAS-fails
            raise OSError(f"store append({key!r}) failed")

    def log_scan(self, prefix: str) -> Dict[str, List[dict]]:
        with self.node._lock:
            return {k: list(v) for k, v in self.node.logs.items()
                    if k.startswith(prefix)}

    def healthy(self) -> bool:
        return self.node.healthy()

    def describe(self) -> str:
        return f"raft:{self.node.nid}@{','.join(self.node.addrs)}"

    def close(self) -> None:
        if self._owns:
            self.node.close()


class RaftClientStore(NamespaceStore):
    """Membership-less store handle over the nodes' RPC port (workers
    resolving pool owners, namespace clients resolving endpoints).
    Reads come from whichever node answers first — possibly a stale
    minority during a partition, by design (discovery must work on
    both sides); mutations are forwarded through that node's quorum
    path and raise :class:`NoQuorumError` when it has none."""

    def __init__(self, addrs: List[str]) -> None:
        if not addrs:
            raise ValueError("RaftClientStore needs node addresses")
        self.addrs = list(addrs)
        self._sock: Optional[socket.socket] = None
        self._rr = 0
        self._lock = threading.Lock()

    def _rpc(self, msg: dict) -> dict:
        with self._lock:
            last: Optional[BaseException] = None
            for i in range(len(self.addrs) * 2):
                if self._sock is None:
                    addr = self.addrs[(self._rr + i) % len(self.addrs)]
                    host, _, port = addr.rpartition(":")
                    try:
                        self._sock = socket.create_connection(
                            (host, int(port)), timeout=2.0)
                        self._sock.settimeout(
                            max(5.0, _PROPOSE_TIMEOUT_S + 2.0))
                        self._rr += i + 1
                    except OSError as e:
                        last = e
                        continue
                try:
                    _send_frame(self._sock, None, msg)
                    reply = _recv_frame(self._sock)
                    if reply is None:
                        raise OSError("store rpc connection closed")
                    return reply
                except OSError as e:
                    last = e
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
            raise OSError(f"no store node reachable "
                          f"({self.addrs}): {last}")

    @staticmethod
    def _check(reply: dict) -> dict:
        err = reply.get("err")
        if err == "NoQuorumError":
            raise NoQuorumError(reply.get("msg", "no quorum"))
        if err:
            raise OSError(f"store rpc failed: {err}: "
                          f"{reply.get('msg')}")
        return reply

    def get(self, key: str) -> Optional[Rec]:
        r = self._check(self._rpc({"t": "read", "op": "get",
                                   "key": key}))
        return _rec_from_tuple(r.get("rec"))

    def cas(self, key: str, expect_ver: Optional[int],
            value: dict) -> Optional[Rec]:
        r = self._check(self._rpc({"t": "write", "op": "cas",
                                   "key": key, "ev": expect_ver,
                                   "val": value}))
        res = r["res"]
        return None if res[0] != "ok" else Rec(value, res[1], res[2])

    def put(self, key: str, value: dict) -> Rec:
        r = self._check(self._rpc({"t": "write", "op": "put",
                                   "key": key, "val": value}))
        res = r["res"]
        return Rec(value, res[1], res[2])

    def delete(self, key: str, expect_ver: Optional[int] = None) -> bool:
        r = self._check(self._rpc({"t": "write", "op": "del",
                                   "key": key, "ev": expect_ver}))
        return r["res"][0] == "ok"

    def scan(self, prefix: str) -> Dict[str, Rec]:
        r = self._check(self._rpc({"t": "read", "op": "scan",
                                   "prefix": prefix}))
        return {k: _rec_from_tuple(v) for k, v in r["recs"].items()}

    def append(self, key: str, record: dict) -> None:
        self._check(self._rpc({"t": "write", "op": "append",
                               "key": key, "rec": record}))

    def log_scan(self, prefix: str) -> Dict[str, List[dict]]:
        r = self._check(self._rpc({"t": "read", "op": "log_scan",
                                   "prefix": prefix}))
        return r["logs"]

    def healthy(self) -> bool:
        try:
            r = self._check(self._rpc({"t": "read", "op": "health"}))
        except (OSError, NoQuorumError):
            return False
        return bool(r.get("healthy"))

    def chaos(self, node_addr: str, msg: dict) -> dict:
        """Send a chaos RPC to ONE SPECIFIC node (partition install /
        stats) — a fresh connection, so the sticky read socket keeps
        its node affinity."""
        host, _, port = node_addr.rpartition(":")
        with socket.create_connection((host, int(port)),
                                      timeout=5.0) as s:
            s.settimeout(10.0)
            _send_frame(s, None, {"t": "chaos", **msg})
            reply = _recv_frame(s)
        if reply is None:
            raise OSError("chaos rpc connection closed")
        return self._check(reply)

    def describe(self) -> str:
        return "raft:" + ",".join(self.addrs)

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


# -- spec resolution ----------------------------------------------------------
#
# A federation "namespace" is now a SPEC string:
#   /path/to/dir                → FileStore
#   raft:<idx>@h0:p0,h1:p1,...  → member: embedded RaftNode idx
#   raft:h0:p0,h1:p1,...        → client: RPC to any node
# Client stores are cached per addr-set (workers resolve owners every
# 100ms — one sticky connection, not one dial per poll).

_CLIENT_CACHE: Dict[Tuple[str, ...], RaftClientStore] = {}
_FILE_CACHE: Dict[str, FileStore] = {}
_CLIENT_CACHE_LOCK = threading.Lock()


def parse_member_spec(spec: str) -> Tuple[int, List[str]]:
    body = spec[len("raft:"):]
    head, _, rest = body.partition("@")
    if not rest:
        raise ValueError(
            f"member spec needs raft:<idx>@addr,...: {spec!r}")
    return int(head), [a.strip() for a in rest.split(",") if a.strip()]


def resolve_store(spec: Any) -> NamespaceStore:
    """Spec → a READ/CLIENT-capable store handle (a member spec
    resolves to a client store over the same group — workers and
    clients never embed a node)."""
    if isinstance(spec, NamespaceStore):
        return spec
    s = str(spec)
    if not s.startswith("raft:"):
        with _CLIENT_CACHE_LOCK:
            store = _FILE_CACHE.get(s)
            if store is None:
                store = _FILE_CACHE[s] = FileStore(s)
            return store
    body = s[len("raft:"):]
    if "@" in body:
        _, addrs = parse_member_spec(s)
    else:
        addrs = [a.strip() for a in body.split(",") if a.strip()]
    key = tuple(addrs)
    with _CLIENT_CACHE_LOCK:
        store = _CLIENT_CACHE.get(key)
        if store is None:
            store = _CLIENT_CACHE[key] = RaftClientStore(addrs)
        return store


def resolve_member_store(spec: Any) -> Tuple[NamespaceStore, bool]:
    """Spec → (store, owns): the server-side resolve.  A ``raft:``
    member spec STARTS this server's embedded node (owns=True: the
    FederationMember's stop() shuts it down); a directory is a shared
    FileStore (owns=False)."""
    if isinstance(spec, NamespaceStore):
        return spec, False
    s = str(spec)
    if s.startswith("raft:"):
        idx, addrs = parse_member_spec(s)
        return RaftStore(RaftNode(idx, addrs)), True
    return FileStore(s), False


def client_spec(spec: Any) -> str:
    """The spec workers/clients should use for the same namespace
    (member raft spec → client raft spec; a dir stays a dir)."""
    if isinstance(spec, NamespaceStore):
        return spec.describe()
    s = str(spec)
    if s.startswith("raft:") and "@" in s:
        _, addrs = parse_member_spec(s)
        return "raft:" + ",".join(addrs)
    return s
