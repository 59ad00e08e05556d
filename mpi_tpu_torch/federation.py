"""Federated serve fabric: leader election, pool takeover, failover — the
port's own copy of ``mpi_tpu/federation.py``: the key helpers and record
readers (:132-256), :func:`wait_pool_owner` (:257), :class:`LeaderLease`
(:291-487), :func:`assert_no_leader_overlap` (:489),
:class:`FederationMember` (:545-783), :func:`federation_stats` (:785) and
:class:`FederatedClient` (:820-1006).  It imports the standard library
and the port's own modules only; the records it writes have the
reference's keys and JSON.

``launcher serve`` (``serve.py``) survives any WORKER death, but a
server process is one process fronting one warm pool: kill it and every
client, lease and worker orphans.  This module federates N servers over
a shared **namespace** (the Ray-GCS / ZooKeeper-lease shape): every
record below lives in a small versioned KV with ATOMIC compare-and-swap
(:class:`~mpi_tpu_torch.federation_store.NamespaceStore`), backed by a
directory (:class:`~mpi_tpu_torch.federation_store.FileStore`, one host
or NFS) or by a replicated Raft-shaped quorum store
(:class:`~mpi_tpu_torch.federation_store.RaftStore`, N servers on N
hosts with no shared filesystem).  A federation "namespace" argument is
a SPEC: a directory path, or ``raft:<idx>@host:port,...`` (server
member) / ``raft:host:port,...`` (client).

* **Endpoint records** — every server renews ``server.<id>`` (pid,
  host, control addr, metrics addr, a light stats summary) each tick;
  a record whose pid is dead (same-host only — pids don't travel) or
  whose renewal is stale past the lease bound IS a dead server.
* **Leader election** (:class:`LeaderLease`) — one ``leader.lease``
  record, acquired and RENEWED by compare-and-swap (the content —
  holder id, pid, term — is immutable per acquisition; a renewal
  re-commits it, refreshing the record's write stamp).  A lease whose
  stamp is stale past ``lease_timeout_s`` is taken over by CAS'ing
  against its exact version — two racing takeovers (or a takeover
  racing a frozen holder's thawed renewal) target the same version
  and exactly ONE wins.  The safety half: a holder's AUTHORITY expires
  ``validity_s = lease_timeout_s/2`` after its last successful renew,
  strictly before any takeover can fire, so a leader frozen past the
  bound (SIGSTOP) has provably lapsed before its usurper begins — and
  on thaw its next renew loses the CAS and DEMOTES.  On the replicated
  store there is a second lapse mode: a minority-side holder's renew
  raises :class:`~mpi_tpu_torch.errors.NoQuorumError` — it does NOT
  demote (it may still be the rightful holder after heal) but it also
  cannot extend, so its authority lapses within ``validity_s`` — the
  Chubby-bounded degradation "minority refuses authority, majority
  serves".  Every acquire/renew appends a ``[from, until]`` authority
  interval to an append-only per-server log (an extension that cannot
  be LOGGED is not granted); :func:`assert_no_leader_overlap` is the
  split-brain assertion the tests run.
* **Pool takeover** — the leader watches the endpoint records; a dead
  server's pools (``pool.<id>`` ownership records) are assigned to
  the least-loaded survivor via a ``takeover.<dead>`` assignment.
  The survivor adopts the pool (``WorldServer.adopt_pool``), rewrites
  the ownership record, and the dead server's ORPHANED WORKERS — whose
  transports, arenas, fault detectors and CUDA contexts are all still
  warm on their cards — re-register with it over the control channel
  (:func:`wait_pool_owner` is the worker-side resolve).  Worker-level
  healing on an adopted pool rides the announce/claim/admit rejoin
  protocol against the adopted rendezvous dir unchanged.
  Double-serving is structurally excluded: a worker serves exactly one
  master at a time (its control connection is the token), and a thawed
  ex-owner that finds a newer ownership record relinquishes — closing
  those connections is precisely what releases the workers to the
  usurper.
* **Client failover** (:class:`FederatedClient`) —
  ``mpi_tpu_torch.connect`` of a server list or a namespace: acquire
  and stats re-resolve live endpoints and retry with backoff on a
  dead-server ``ServerLostError`` — or a minority-side server's
  ``NoQuorumError`` (re-acquire is idempotent — a lease whose server
  died, died with it); an in-flight ``lease.run`` surfaces the named
  error instead of transparently re-running a possibly-side-effecting
  job.
* **Roll-up** (:func:`federation_stats`) — the per-server summaries in
  the endpoint records aggregate into one namespace-level document, so
  the Prometheus endpoint stays truthful when pools move between
  servers.
"""

from __future__ import annotations

import os
import socket as _socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from . import federation_store as _fstore
from . import resilience as _resilience
from . import telemetry as _telemetry
from .errors import NoQuorumError
from .membership import _pid_alive
from .transport.base import TransportError

# One leadership/liveness knob: a leader lease (and a server endpoint
# record) untouched for this long belongs to a dead or frozen process
# and is taken over.  Authority self-expires at HALF this bound
# (_VALIDITY_FRACTION), so an ex-holder's authority provably lapses
# before any takeover can begin — the no-overlap invariant the
# split-brain test asserts.  Per-server override: WorldServer
# fed_lease_timeout_s / ``launcher serve --fed-lease-timeout``.
_LEASE_TIMEOUT_S = 3.0
_VALIDITY_FRACTION = 0.5

# Endpoint records are judged dead a bit later than the leader lease
# (renewals ride the same tick; the margin absorbs one missed tick
# under load before a takeover storm starts).
_SERVER_STALE_FACTOR = 1.5

_TICK_S = 0.25          # federation member duty cadence
_LEASE_KEY = "leader.lease"
_OWNER_POLL_S = 0.1     # orphaned-worker resolve cadence

# Client-side liveness filter for endpoint records: liberal (a dial
# failure skips a dead candidate anyway); the pid check does the fast
# discrimination for same-host records.
_CLIENT_RECORD_STALE_S = 10.0

_HOSTNAME = _socket.gethostname()

# store-read failures helpers swallow (a raft client store with every
# node briefly unreachable raises OSError; a directory listing of a
# torn-down namespace likewise) — reads degrade to "nothing visible",
# mutations surface their errors to the caller
_READ_ERRORS = (OSError, NoQuorumError)


def _store(ns: Any) -> "_fstore.NamespaceStore":
    """Namespace spec (dir path / raft: spec / store instance) → store
    handle.  Cached per spec inside federation_store.resolve_store."""
    return _fstore.resolve_store(ns)


def _ns_name(ns: Any) -> str:
    return ns.describe() if isinstance(ns, _fstore.NamespaceStore) \
        else str(ns)


# -- namespace record helpers -------------------------------------------------


def _server_key(sid: str) -> str:
    return f"server.{sid}"


def _pool_key(pool_id: str) -> str:
    return f"pool.{pool_id}"


def _takeover_key(sid: str) -> str:
    return f"takeover.{sid}"


def _log_key(sid: str) -> str:
    return f"leader.log.{sid}"


def read_server_records(ns: Any) -> Dict[str, dict]:
    """All ``server.<id>`` endpoint records in the namespace."""
    out: Dict[str, dict] = {}
    try:
        recs = _store(ns).scan("server.")
    except _READ_ERRORS:
        return out
    for rec in recs.values():
        val = rec.value
        if val and val.get("id"):
            out[val["id"]] = val
    return out


def read_server_record(ns: Any, sid: str) -> Optional[dict]:
    try:
        rec = _store(ns).get(_server_key(sid))
    except _READ_ERRORS:
        return None
    return None if rec is None else rec.value


def read_leader(ns: Any) -> Optional[dict]:
    """The current ``leader.lease`` content (holder id/pid/term), or
    None with no leader elected — a RELEASED lease (clean shutdown
    left the record as a term tombstone) reads as no leader.  Record
    ownership only — whether the holder's AUTHORITY is still valid is
    its own clock's business (LeaderLease.is_leader)."""
    try:
        rec = _store(ns).get(_LEASE_KEY)
    except _READ_ERRORS:
        return None
    if rec is None or rec.value is None or rec.value.get("released"):
        return None
    return rec.value


def record_live(rec: dict, now: Optional[float] = None,
                stale_s: float = _CLIENT_RECORD_STALE_S) -> bool:
    """Is this endpoint record's server alive?  Dead pid → dead NOW
    (kill -9 detection is one stat) — but only for a record written on
    THIS host; a pid from another host is meaningless here, so remote
    records are judged by renewal staleness alone (the frozen-server
    case: SIGSTOP keeps the pid but stops the renewals)."""
    host = rec.get("host")
    if host is None or host == _HOSTNAME:
        pid = rec.get("pid")
        if pid is not None and not _pid_alive(int(pid)):
            return False
    now = time.time() if now is None else now
    return now - float(rec.get("renewed_at", 0)) <= stale_s


def write_pool_owner(ns: Any, pool_id: str, owner: str, ctrl: str,
                     rdv: str, backend: str, size: int, epoch: int,
                     term: int, since: Optional[float] = None) -> None:
    """Publish/replace the ownership record of one pool.  ``since`` is
    the wall time ownership began — an ex-owner relinquishes on seeing
    a record with a different owner and a ``since`` at or past its own
    (the thawed-usurped-server demotion path)."""
    _store(ns).put(_pool_key(pool_id), {
        "pool": pool_id, "owner": owner, "ctrl": ctrl, "rdv": rdv,
        "backend": backend, "size": int(size), "epoch": int(epoch),
        "term": int(term),
        "since": time.time() if since is None else float(since)})


def read_pool_owner(ns: Any, pool_id: str) -> Optional[dict]:
    try:
        rec = _store(ns).get(_pool_key(pool_id))
    except _READ_ERRORS:
        return None
    return None if rec is None else rec.value


def read_pool_owners(ns: Any) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    try:
        recs = _store(ns).scan("pool.")
    except _READ_ERRORS:
        return out
    for rec in recs.values():
        if rec.value and rec.value.get("pool"):
            out[rec.value["pool"]] = rec.value
    return out


def read_takeovers(ns: Any) -> List[dict]:
    try:
        recs = _store(ns).scan("takeover.")
    except _READ_ERRORS:
        return []
    return [rec.value for rec in recs.values() if rec.value]


def wait_pool_owner(ns: Any, pool_id: str, not_ctrl: Optional[str],
                    timeout: float,
                    stale_s: float = _CLIENT_RECORD_STALE_S
                    ) -> Optional[str]:
    """Orphaned-worker resolve: block until the pool's ownership record
    names a control address other than ``not_ctrl`` (the address whose
    ESTABLISHED registration just died; None excludes nothing — a
    merely-unreachable owner may resolve again) and its owner's
    endpoint record, when present, reads live — or the orphan budget
    runs out (→ None: the worker exits rather than leak).  Each
    death round passes its own just-dead address, so a chain of server
    deaths keeps resolving forward."""
    st = _store(ns)
    deadline = time.monotonic() + timeout
    while True:
        try:
            prec = st.get(_pool_key(pool_id))
            rec = None if prec is None else prec.value
            if rec is not None and rec.get("ctrl") \
                    and rec["ctrl"] != not_ctrl:
                srec = st.get(_server_key(str(rec.get("owner"))))
                srv = None if srec is None else srec.value
                if srv is None or record_live(srv, stale_s=stale_s):
                    return rec["ctrl"]
        except _READ_ERRORS:
            pass  # store briefly unreachable: the budget is the bound
        if time.monotonic() > deadline:
            return None
        time.sleep(_OWNER_POLL_S)


# -- the leader lease ---------------------------------------------------------


class LeaderLease:
    """Store-lease leader election (the FileBoard
    ``pending.summary.lock`` idiom, grown the two properties an
    AUTHORITY needs that a compaction lock does not, both built on the
    store CAS so they are arbitration, not timing):

    * **bounded authority** — holding the record is necessary but not
      sufficient; :meth:`is_leader` is true only within ``validity_s``
      of the last *successful* renew, and ``validity_s`` is strictly
      below the takeover bound, so a frozen holder's authority lapses
      before a usurper's can begin.  On the replicated store a
      minority-side renew raises ``NoQuorumError``: the holder does
      not demote (post-heal it may still rightfully hold) but cannot
      extend either — authority lapses, the minority refuses.
    * **immutable content per term** — the lease content (id, pid,
      host, term) is fixed at acquisition; a renew re-commits the SAME
      content by CAS against the exact version last observed, which
      refreshes the record's write stamp (the staleness clock).  A
      takeover CAS'es against a stale record's version with term+1.
      Any interleaving of a thawed holder's renew and a takeover is a
      single-winner CAS race.

    Every acquire and renew appends the authority interval
    ``[from, until]`` to the ``leader.log.<id>`` append-only log (one
    writer per log — no contention) BEFORE the validity extension
    takes effect: an interval that cannot be logged is not granted.
    :func:`assert_no_leader_overlap` checks the whole namespace's
    history for the split-brain condition."""

    def __init__(self, ns: Any, owner_id: str,
                 lease_timeout_s: float = _LEASE_TIMEOUT_S) -> None:
        self.ns = ns
        self.store = _store(ns)
        self.owner_id = owner_id
        self.lease_timeout_s = float(lease_timeout_s)
        self.validity_s = _VALIDITY_FRACTION * self.lease_timeout_s
        self.term = 0
        self.takeovers = 0        # stale leases reclaimed by US
        self.demotions = 0        # times we discovered usurpation
        self.quorum_stalls = 0    # renews refused by NoQuorumError
        self._held = False
        self._valid_until_mono = 0.0
        self._content: dict = {}

    def is_leader(self) -> bool:
        """Authority check — NOT just record ownership: false the
        moment ``validity_s`` elapses since the last successful renew,
        which is how a frozen (or minority-partitioned) leader knows
        it must re-verify before acting."""
        return self._held and time.monotonic() < self._valid_until_mono

    def _mine(self, val: Optional[dict]) -> bool:
        return (val is not None and not val.get("released")
                and val.get("id") == self.owner_id
                and val.get("pid") == os.getpid()
                and val.get("host", _HOSTNAME) == _HOSTNAME
                and int(val.get("term", -1)) == self.term)

    def _log_interval(self, now_wall: float) -> None:
        # raises on failure (quorum loss / namespace teardown): the
        # caller treats an unlogged extension as no extension
        self.store.append(_log_key(self.owner_id), {
            "id": self.owner_id, "term": self.term,
            "from": now_wall, "until": now_wall + self.validity_s})

    def tick(self) -> bool:
        """Acquire-or-renew; returns whether we hold valid authority
        after the tick.  Called on the federation member cadence."""
        return self._renew() if self._held else self._try_acquire()

    def _try_acquire(self) -> bool:
        st = self.store
        try:
            cur = st.get(_LEASE_KEY)
        except _READ_ERRORS:
            return False
        next_term = self.term + 1
        expect = None
        takeover = False
        if cur is not None and cur.value is not None:
            val = cur.value
            next_term = max(next_term, int(val.get("term", 0)) + 1)
            expect = cur.ver
            if not val.get("released"):
                # a released lease is a term TOMBSTONE (clean
                # shutdown): immediately claimable — and the term
                # history survives it.  A live one must be stale.
                if time.time() - cur.stamp < self.lease_timeout_s:
                    return False  # live holder
                takeover = True
        now_mono, now_wall = time.monotonic(), time.time()
        content = {"id": self.owner_id, "pid": os.getpid(),
                   "host": _HOSTNAME, "term": next_term,
                   "acquired_at": now_wall}
        try:
            # THE arbitration: against the exact version we judged
            # stale (or absence).  A renew that landed since — or a
            # rival takeover — moved the version, and we lose cleanly.
            rec = st.cas(_LEASE_KEY, expect, content)
        except NoQuorumError:
            self.quorum_stalls += 1
            return False  # minority side: authority refused, by design
        except OSError:
            return False  # store unreachable / namespace teardown
        if rec is None:
            return False  # lost the CAS race
        self.term = next_term
        self._content = content
        self._lease_ver = rec.ver
        if takeover:
            self.takeovers += 1
        self._held = True
        try:
            self._log_interval(now_wall)
        except _READ_ERRORS:
            # we hold the record but could not log the interval: grant
            # ZERO validity (we never act on unlogged authority); the
            # next tick renews and retries the log
            self._valid_until_mono = 0.0
            return False
        # authority anchored BEFORE the write: conservative
        self._valid_until_mono = now_mono + self.validity_s
        rec_t = _telemetry.REC
        if rec_t is not None:
            rec_t.emit("serve", "leader_elected",
                       attrs={"id": self.owner_id, "term": self.term,
                              "takeover": self.takeovers > 0})
        return True

    def _renew(self) -> bool:
        st = self.store
        now_mono, now_wall = time.monotonic(), time.time()
        try:
            cur = st.get(_LEASE_KEY)
        except _READ_ERRORS:
            return False  # cannot verify: no extension, let it lapse
        if cur is None or not self._mine(cur.value):
            return self._demote("usurped")
        try:
            rec = st.cas(_LEASE_KEY, cur.ver, self._content)
        except NoQuorumError:
            # minority side of a partition: we may STILL be the
            # rightful holder (the majority has judged nothing yet) —
            # do not demote, but do not extend: authority lapses
            # within validity_s and this side refuses leadership
            self.quorum_stalls += 1
            return False
        except OSError:
            return False
        if rec is None:
            # single-winner CAS: a takeover landed between our read
            # and our write
            return self._demote("usurped")
        self._lease_ver = rec.ver
        try:
            self._log_interval(now_wall)
        except _READ_ERRORS:
            return False  # unlogged extension = no extension
        self._valid_until_mono = now_mono + self.validity_s
        return True

    def _demote(self, why: str) -> bool:
        self._held = False
        self._valid_until_mono = 0.0
        self.demotions += 1
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("serve", "leader_demoted",
                     attrs={"id": self.owner_id, "term": self.term,
                            "why": why})
        return False

    def release(self) -> None:
        """Clean handoff at shutdown: mark the lease RELEASED (a term
        tombstone the next acquirer claims immediately and bumps past —
        deleting would lose the term history) and log the reign's end,
        capping our authority interval at NOW rather than letting the
        last renew's ``until`` imply authority we gave up."""
        held, self._held = self._held, False
        self._valid_until_mono = 0.0
        if not held:
            return
        now_wall = time.time()
        try:
            cur = self.store.get(_LEASE_KEY)
            if cur is not None and self._mine(cur.value):
                self.store.cas(_LEASE_KEY, cur.ver,
                               {**self._content, "released": True})
            self.store.append(_log_key(self.owner_id), {
                "id": self.owner_id, "term": self.term,
                "release": True, "until": now_wall})
        except _READ_ERRORS:
            pass


def assert_no_leader_overlap(ns: Any) -> List[dict]:
    """THE split-brain assertion: parse every server's authority-
    interval log and verify no two DIFFERENT servers' intervals
    overlap.  Returns the parsed intervals (sorted) for diagnostics;
    raises AssertionError naming the clash.  The intervals are what
    each server believed its authority to be (from its own renews),
    logged conservatively — an overlap here means two servers could
    both have acted as leader at one instant."""
    raw: List[dict] = []
    try:
        logs = _store(ns).log_scan("leader.log.")
    except _READ_ERRORS:
        logs = {}
    for entries in logs.values():
        raw.extend(entries)
    # a release record caps its (id, term) reign at the release instant
    # — authority voluntarily given up must not read as held through
    # the last renew's validity window
    releases: Dict[tuple, float] = {}
    for e in raw:
        if e.get("release"):
            key = (e["id"], e.get("term"))
            releases[key] = min(releases.get(key, float("inf")),
                                float(e["until"]))
    intervals = []
    for e in raw:
        if e.get("release"):
            continue
        cap = releases.get((e["id"], e.get("term")))
        e = dict(e)
        if cap is not None:
            e["until"] = min(float(e["until"]), cap)
        if e["until"] > e["from"]:
            intervals.append(e)
    intervals.sort(key=lambda e: e["from"])
    # merge per-id runs first (renews of one reign overlap by design)
    merged: List[dict] = []
    for e in intervals:
        if merged and merged[-1]["id"] == e["id"] \
                and e["from"] <= merged[-1]["until"]:
            merged[-1]["until"] = max(merged[-1]["until"], e["until"])
        else:
            merged.append(dict(e))
    for a, b in zip(merged, merged[1:]):
        if a["id"] != b["id"] and b["from"] < a["until"]:
            raise AssertionError(
                f"leader authority overlap: {a['id']} (term {a['term']}) "
                f"held until {a['until']:.3f} but {b['id']} (term "
                f"{b['term']}) began at {b['from']:.3f} "
                f"({a['until'] - b['from']:.3f}s overlap)")
    return merged


# -- the per-server federation member ----------------------------------------


class FederationMember:
    """The federation duties of ONE server, run on a daemon thread at
    ``_TICK_S``: renew the endpoint record, tick the leader lease,
    publish/verify pool ownership (relinquishing pools a usurper took
    while we were frozen), consume takeover assignments addressed to
    us, and — while holding valid leader authority — assign dead
    servers' pools to survivors and garbage-collect their records.
    A tick that raises logs a structured line and keeps ticking (the
    serve monitor-loop rule: the fabric's lifeline must not die of one
    exception).  On a ``raft:<idx>@...`` namespace spec the member
    STARTS its embedded store node; a tick on the minority side of a
    partition (store unhealthy) skips every mutation — the lease
    lapses, the admission fence in serve.py refuses clients, and the
    majority side carries the fabric."""

    def __init__(self, server, ns: Any,
                 server_id: Optional[str] = None,
                 lease_timeout_s: float = _LEASE_TIMEOUT_S,
                 tick_s: float = _TICK_S) -> None:
        self.server = server
        self.ns = ns
        self.store, self._owns_store = _fstore.resolve_member_store(ns)
        self.server_id = server_id or ("srv-" + uuid.uuid4().hex[:8])
        self.lease = LeaderLease(self.store, self.server_id,
                                 lease_timeout_s)
        self.tick_s = float(tick_s)
        self.server_stale_s = _SERVER_STALE_FACTOR * float(lease_timeout_s)
        self.started_at = time.time()
        self.unhealthy_ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def is_leader(self) -> bool:
        return self.lease.is_leader()

    def healthy(self) -> bool:
        """Can this member's store commit (quorum reachability)?  The
        serve.py admission fence consults this: a minority-side server
        refuses new leases with the named ``NoQuorumError``."""
        return self.store.healthy()

    def start(self) -> "FederationMember":
        self._tick_safe()  # register synchronously: visible on return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"fed-{self.server_id}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # clean departure: release the lease, retract our records (the
        # pools die with an orderly stop() — serve shuts the workers
        # down — so their ownership records retract too)
        try:
            self.lease.release()
            for pool_id, rec in read_pool_owners(self.store).items():
                if rec.get("owner") == self.server_id:
                    self.store.delete(_pool_key(pool_id))
            self.store.delete(_server_key(self.server_id))
        except _READ_ERRORS:
            pass  # partitioned/torn-down at exit: records go stale
        if self._owns_store:
            self.store.close()

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            self._tick_safe()

    def _tick_safe(self) -> None:
        try:
            self._tick()
        except Exception as e:  # noqa: BLE001 - the fabric's lifeline
            if self._stop.is_set():
                return
            import sys
            import traceback

            sys.stderr.write(
                f"mpi_tpu_torch.federation: member tick failed "
                f"({type(e).__name__}: {str(e)[:200]}) — ticking on:\n"
                f"{traceback.format_exc()}")

    # -- duties ------------------------------------------------------------

    def _tick(self) -> None:
        now = time.time()
        if not self.store.healthy():
            # minority side: every mutation below would burn a propose
            # timeout and fail with NoQuorumError anyway.  Skip the
            # tick wholesale — the lease lapses by not renewing
            # (is_leader() goes false within validity_s), the stale
            # endpoint record steers clients at the majority, and the
            # admission fence names the refusal.
            self.unhealthy_ticks += 1
            rec = _telemetry.REC
            if rec is not None:
                rec.emit("serve", "fed_tick_no_quorum",
                         attrs={"id": self.server_id})
            return
        self._write_server_record(now)
        leading = self.lease.tick()
        # ONE pool-record snapshot per tick, shared by every duty
        # (each used to rescan the namespace itself — 3-4 scans per
        # 250ms tick per server, multiplied across the fabric);
        # staleness within a tick is harmless, every consumer
        # re-checks live server state before acting
        owners = read_pool_owners(self.store)
        self._verify_pool_ownership(owners)
        self._reclaim_ghost_pools(owners)
        self._consume_assignments()
        if leading and self.lease.is_leader():
            self._leader_duties(now, owners)

    def _write_server_record(self, now: float) -> None:
        self.store.put(_server_key(self.server_id), {
            "id": self.server_id, "pid": os.getpid(),
            "host": _HOSTNAME,
            "ctrl": self.server.addr,
            "metrics": getattr(self.server, "metrics_addr", None),
            "started_at": self.started_at, "renewed_at": now,
            "is_leader": self.lease.is_leader(),
            "term": self.lease.term,
            "summary": self.server.fed_summary()})

    def _verify_pool_ownership(self, owners: Dict[str, dict]) -> None:
        """Publish ownership for pools we hold; RELINQUISH any pool the
        namespace says a usurper took over while we were frozen (the
        split-brain-avoidance half of pool handover: our closing of the
        worker control connections is what releases the workers)."""
        for pool_id, meta in self.server.owned_pool_records().items():
            rec = owners.get(pool_id)
            if rec is None:
                write_pool_owner(
                    self.store, pool_id, owner=self.server_id,
                    ctrl=self.server.addr, rdv=meta["rdv"],
                    backend=meta["backend"], size=meta["size"],
                    epoch=meta["epoch"], term=self.lease.term,
                    since=meta["since"])
            elif (rec.get("owner") != self.server_id
                  and float(rec.get("since", 0)) >= float(meta["since"])):
                self.server.relinquish_pool(pool_id, rec.get("owner"))

    def _reclaim_ghost_pools(self, owners: Dict[str, dict]) -> None:
        """A pool record naming US that we do not actually serve is a
        ghost of our PREVIOUS incarnation (a restart under a stable
        ``--server-id``): the record reads live to the leader (our new
        pid renews ``server.<id>``), so no takeover will ever fire for
        it — reclaim it ourselves.  The old incarnation's warm orphans
        are excluding its DEAD control address in their re-resolve;
        rewriting the record with our new address is what brings them
        home."""
        owned = self.server.owned_pool_records()
        for pool_id, rec in owners.items():
            if rec.get("owner") != self.server_id or pool_id in owned:
                continue
            if self.server.adopt_pool(pool_id, rec,
                                      term=self.lease.term):
                write_pool_owner(
                    self.store, pool_id, owner=self.server_id,
                    ctrl=self.server.addr, rdv=rec["rdv"],
                    backend=rec.get("backend", "socket"),
                    size=int(rec["size"]),
                    epoch=int(rec.get("epoch", 0)),
                    term=self.lease.term)

    def _consume_assignments(self) -> None:
        for t in read_takeovers(self.store):
            if t.get("to") != self.server_id:
                continue
            for pool_id, prec in (t.get("pools") or {}).items():
                cur = read_pool_owner(self.store, pool_id)
                if cur is not None and cur.get("owner") not in (
                        t.get("dead"), self.server_id):
                    continue  # moved again since: stale assignment
                if cur is not None and cur.get("owner") == self.server_id:
                    continue  # already adopted
                if self.server.adopt_pool(pool_id, prec,
                                          term=int(t.get("term", 0))):
                    write_pool_owner(
                        self.store, pool_id, owner=self.server_id,
                        ctrl=self.server.addr, rdv=prec["rdv"],
                        backend=prec.get("backend", "socket"),
                        size=int(prec["size"]),
                        epoch=int(prec.get("epoch", 0)),
                        term=int(t.get("term", 0)))

    def _leader_duties(self, now: float,
                       owners: Dict[str, dict]) -> None:
        records = read_server_records(self.store)
        live = {sid for sid, r in records.items()
                if sid == self.server_id
                or record_live(r, now, self.server_stale_s)}
        for sid, r in records.items():
            if sid in live:
                continue
            dead_pools = {pid: rec for pid, rec in owners.items()
                          if rec.get("owner") == sid}
            if dead_pools:
                existing = None
                trec = self.store.get(_takeover_key(sid))
                if trec is not None:
                    existing = trec.value
                if existing is None or existing.get("to") not in live:
                    target = self._choose_survivor(live, owners)
                    if target is not None and self.lease.is_leader():
                        # assignments carry the term they were decided
                        # under — written ONLY with valid authority
                        self.store.put(_takeover_key(sid), {
                            "dead": sid, "to": target,
                            "term": self.lease.term, "at": now,
                            "pools": dead_pools})
                        rec_t = _telemetry.REC
                        if rec_t is not None:
                            rec_t.emit("serve", "takeover_assigned",
                                       attrs={"dead": sid, "to": target,
                                              "pools":
                                              sorted(dead_pools)})
            else:
                # fully relieved (or never owned a pool): GC the corpse
                self.store.delete(_server_key(sid))
                self.store.delete(_takeover_key(sid))

    def _choose_survivor(self, live: set,
                         owners: Dict[str, dict]) -> Optional[str]:
        """Least-loaded live server (fewest owned pools, id tiebreak) —
        the leader may assign to itself."""
        if not live:
            return None
        load = {sid: 0 for sid in live}
        for rec in owners.values():
            if rec.get("owner") in load:
                load[rec["owner"]] += 1
        return min(sorted(load), key=lambda sid: load[sid])


# -- namespace roll-up --------------------------------------------------------


def federation_stats(ns: Any) -> dict:
    """Aggregate the namespace: one document summing the live servers'
    summaries (worlds/s, workers, idle, pools, waiting) plus the
    current leader — what keeps the Prometheus endpoint truthful
    when pools move between servers.  Pure store reads: scrape-safe,
    callable with zero servers reachable (and on the MINORITY side of
    a store partition, where it reports the last applied state)."""
    now = time.time()
    records = read_server_records(ns)
    lease = read_leader(ns)
    servers = {}
    totals = {"worlds_per_s": 0.0, "workers": 0, "idle": 0, "pools": 0,
              "leases_active": 0, "waiting": 0}
    live = 0
    for sid, r in sorted(records.items()):
        alive = record_live(r, now)
        summary = r.get("summary") or {}
        servers[sid] = {"live": alive, "ctrl": r.get("ctrl"),
                        "is_leader": bool(r.get("is_leader")),
                        **summary}
        if alive:
            live += 1
            for k in totals:
                totals[k] = totals[k] + summary.get(k, 0)
    totals["worlds_per_s"] = round(totals["worlds_per_s"], 3)
    return {"namespace": _ns_name(ns), "servers_total": len(records),
            "servers_live": live,
            "leader": lease.get("id") if lease else None,
            "leader_term": int(lease.get("term", 0)) if lease else 0,
            "servers": servers, **totals}


# -- the failover client ------------------------------------------------------


class FederatedClient:
    """Client handle to a FEDERATION of world servers: resolve live
    endpoints from a namespace (dir or ``raft:`` spec, and/or a static
    address list), and fail acquire/stats over to a survivor on a
    dead-server ``ServerLostError`` — or a partitioned minority
    server's ``NoQuorumError`` — with backoff, bounded by the
    ``connect_retry_timeout_s`` budget.  Lease semantics are the
    single-server ones: re-acquire after a failover is idempotent (the
    lost lease died with its server), and an in-flight ``lease.run``
    surfaces the named error — jobs are not transparently re-run."""

    def __init__(self, namespace: Optional[str] = None,
                 addrs: Optional[List[Any]] = None,
                 timeout: float = 30.0, priority: int = 0,
                 failover_timeout_s: Optional[float] = None) -> None:
        if not namespace and not addrs:
            raise ValueError("FederatedClient needs a namespace "
                             "and/or a server address list")
        self._ns = namespace
        self._static = ["%s:%s" % tuple(a) if isinstance(a, (tuple, list))
                        else str(a) for a in (addrs or [])]
        self._timeout = float(timeout)
        self._priority = int(priority)
        self._id = uuid.uuid4().hex  # one fair-share identity across servers
        self._failover_s = failover_timeout_s
        self._client = None
        self._addr: Optional[str] = None
        self._rr = 0
        self.failovers = 0

    # -- endpoint resolution ----------------------------------------------

    def _budget(self) -> float:
        if self._failover_s is not None:
            return float(self._failover_s)
        from . import mpit as _mpit

        return float(_mpit.cvar_read("connect_retry_timeout_s"))

    def _candidates(self) -> List[str]:
        out = list(self._static)
        if self._ns:
            now = time.time()
            # freshest renewal first: a SIGSTOP-frozen server's record
            # passes record_live until it ages past the stale bound,
            # but its renewals have already stopped — ordering by
            # recency steers a fresh client at the actively-renewing
            # survivor instead of the silent not-yet-stale ex-leader
            # (id order was the tiebreak that dialed the frozen one
            # first every time).  Ties (all healthy) stay deterministic
            # via the id in the sort key.  The same ordering is the
            # partition play: minority-side servers stop renewing
            # their records, so clients drain toward the majority.
            recs = sorted(read_server_records(self._ns).items(),
                          key=lambda kv: (-float(
                              kv[1].get("renewed_at", 0)), kv[0]))
            for sid, rec in recs:
                if rec.get("ctrl") and record_live(rec, now) \
                        and rec["ctrl"] not in out:
                    out.append(rec["ctrl"])
        return out

    def _ensure(self):
        if self._client is not None:
            return self._client
        from . import serve as _serve

        deadline = time.monotonic() + max(self._budget(), 0.0)
        delays = _resilience.backoff_delays()
        last_err: Optional[BaseException] = None
        while True:
            cands = self._candidates()
            for i in range(len(cands)):
                addr = cands[(self._rr + i) % len(cands)]
                host, _, port = addr.rpartition(":")
                try:
                    # a short per-candidate dial budget: OUR loop is
                    # the patience; a dead candidate must not eat the
                    # whole failover budget before the next is tried.
                    # The cap applies to the SINGLE connect attempt
                    # too (timeout=), not just the retry loop — a
                    # SYN-blackholed candidate would otherwise block
                    # the full client timeout before the live survivor
                    # is ever dialed
                    c = _serve.ServerClient(
                        host, int(port),
                        timeout=min(self._timeout, 2.0),
                        priority=self._priority, client_id=self._id,
                        dial_retry_s=0.5)
                except OSError as e:
                    last_err = e
                    continue
                self._client, self._addr = c, addr
                self._rr = (self._rr + i + 1) % max(1, len(cands))
                return c
            if time.monotonic() > deadline:
                raise _serve.ServerLostError(
                    f"no live federation server reachable "
                    f"(candidates {cands or 'none'}; last: "
                    f"{type(last_err).__name__ if last_err else 'none'}: "
                    f"{last_err})")
            time.sleep(min(next(delays), 0.5))

    def _drop(self) -> None:
        c, self._client, self._addr = self._client, None, None
        if c is not None:
            try:
                c.close()
            except OSError:
                pass

    def _with_failover(self, op):
        from .serve import ServerLostError

        deadline = time.monotonic() + max(self._budget(), 0.0)
        delays = _resilience.backoff_delays()
        while True:
            client = self._ensure()
            try:
                return op(client)
            except (ServerLostError, NoQuorumError, OSError) as e:
                if isinstance(e, TimeoutError) \
                        and not isinstance(e, ServerLostError):
                    # a LEASE timeout (TimeoutError is an OSError
                    # subclass!) is the live server's named verdict,
                    # not a dead server — never a failover signal
                    raise
                # NoQuorumError IS a failover signal: the server is
                # alive but on the minority side of a store partition —
                # refusing by design; a majority-side server can serve
                self._drop()
                self.failovers += 1
                if time.monotonic() > deadline:
                    raise
                time.sleep(min(next(delays), 0.25))

    # -- the ServerClient surface ------------------------------------------

    @property
    def addr(self) -> Optional[str]:
        """Control address currently connected (None when dropped)."""
        return self._addr

    def acquire(self, nranks: int, timeout: Optional[float] = None,
                priority: Optional[int] = None):
        """Lease ``nranks`` warm workers from any live server —
        failover-transparent (re-acquire is idempotent).  Named
        non-failover errors propagate: ``ServerBusyError`` (admission
        rejection), ``TimeoutError`` (pool busy past the bound)."""
        return self._with_failover(
            lambda c: c.acquire(nranks, timeout=timeout,
                                priority=priority))

    def run(self, fn, *args: Any, nranks: int = 2,
            timeout: Optional[float] = None) -> Any:
        """acquire (with failover) + run + release.  A server death
        MID-JOB raises the named ``ServerLostError`` — the job may have
        side effects, so re-running it is the caller's decision."""
        lease = self.acquire(nranks, timeout=timeout)
        try:
            return lease.run(fn, *args, timeout=timeout)
        finally:
            try:
                lease.release()
            except (TransportError, OSError):
                pass  # server gone: the lease died with it

    def stats(self) -> dict:
        """One live server's stats document (failover-transparent);
        federated servers embed the namespace roll-up under
        ``"federation"``."""
        return self._with_failover(lambda c: c.stats())

    def federation_stats(self) -> dict:
        """The namespace roll-up directly (no server round-trip)."""
        if not self._ns:
            return self.stats().get("federation") or {}
        return federation_stats(self._ns)

    def close(self) -> None:
        self._drop()

    def __enter__(self) -> "FederatedClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
