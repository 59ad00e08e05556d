"""Verifier state: pending-op boards, per-rank world state, lint registry —
the port's own copy of ``mpi_tpu/verify/state.py``: the report functions
(:47-66), ``user_site`` (:66), ``MemoryBoard`` (:86), ``FileBoard`` (:122)
with its summary compaction and lock, ``VInfo`` (:412), ``WorldVerify``
(:447), ``CommVerify`` (:616) and ``finalize_report`` (:648).

Buffer ranges are tensor ranges: the overlap lint keys each live range by
its device and spans it from the view's first byte (the storage's
``data_ptr()`` plus ``storage_offset()``) to one past the last element its
strides reach, so two views of one CUDA tensor overlap exactly where
their elements interleave, and a CPU and a CUDA tensor never do.

The runtime verifier (MUST-style) needs one out-of-band
channel: when a rank has been blocked past ``verify_stall_timeout_s`` it
publishes WHAT it is blocked in (source set, AND/OR semantics, tag,
collective, call site) and reads every peer's published entry, so the
wait-for-graph analysis (``checker.find_deadlock``) can run on the
full cross-rank picture without any rank being able to answer a message.
Two substrates behind one Board interface, mirroring ft.py's liveness
split:

* :class:`MemoryBoard` — a shared in-process table for the local thread
  world (``run(..., backend="local", verify=True)`` creates one per
  world).
* :class:`FileBoard` — ``pending.<rank>`` JSON files under the launcher
  rendezvous dir for process worlds (socket/shm; ``MPI_TPU_VERIFY=1``).

Everything else here is rank-local bookkeeping: the live-request set
(leak / double-wait lints), live nonblocking buffer ranges (the
message-race overlap lint), created-communicator registry (unfreed-comm
lint), and the process-wide diagnostic report the finalize check and
``take_report()`` drain.
"""

from __future__ import annotations

import json
import os
import threading
import weakref
from typing import Dict, List, Optional, Tuple

from .. import mpit as _mpit
from .. import bufpool as _bufpool

# Default stall bound before a blocked wait publishes its pending op and
# starts running deadlock analysis.  mpit cvar: verify_stall_timeout_s.
_STALL_TIMEOUT_S = 5.0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's own example programs live inside the package; their frames
# are user frames
_EXAMPLES_DIR = os.path.join(_PKG_DIR, "examples") + os.sep

# -- the process-wide diagnostic report --------------------------------------

_report_lock = threading.Lock()
_REPORT: List[str] = []
_WORLDS: "weakref.WeakSet" = weakref.WeakSet()


def report_add(msg: str) -> None:
    with _report_lock:
        _REPORT.append(msg)


def take_report() -> List[str]:
    """Drain and return every diagnostic the verifier has recorded in
    this process (lints are REPORTED, not raised — MUST-style; deadlock
    and collective mismatch raise in addition to reporting)."""
    with _report_lock:
        out, _REPORT[:] = list(_REPORT), []
    return out


def peek_report() -> List[str]:
    with _report_lock:
        return list(_REPORT)


def user_site(skip_dir: str = _PKG_DIR) -> str:
    """file:lineno of the nearest caller OUTSIDE this package (its
    ``examples/`` count as outside) — the call site every diagnostic
    names.  Only ever invoked with the verifier on."""
    import sys

    try:
        f = sys._getframe(1)
    except ValueError:  # pragma: no cover - no frames
        return "<unknown>"
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(skip_dir) or fn.startswith(_EXAMPLES_DIR):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "<mpi_tpu_torch internals>"


# -- out-of-band pending-op boards -------------------------------------------


class MemoryBoard:
    """Shared pending-op table for one in-process world (thread ranks).

    ``read_all`` attaches each entry's age since publish (``_age_s``):
    a genuinely stalled rank refreshes its entry every analysis slice,
    so the deadlock analysis EXPIRES un-refreshed 'blocked' entries —
    the last-resort guard against a stale entry left behind by a rank
    that died mid-stall (ended waits retract their entries promptly)."""

    def __init__(self, size: int) -> None:
        self._entries: List[Optional[Tuple[float, dict]]] = [None] * size
        self._lock = threading.Lock()

    def publish(self, rank: int, entry: Optional[dict]) -> None:
        import time

        with self._lock:
            self._entries[rank] = (None if entry is None
                                   else (time.monotonic(), entry))

    def read_all(self) -> Dict[int, dict]:
        import time

        now = time.monotonic()
        with self._lock:
            out = {}
            for r, slot in enumerate(self._entries):
                if slot is None:
                    continue
                at, e = slot
                d = dict(e)
                d["_age_s"] = now - at
                out[r] = d
            return out


class FileBoard:
    """``pending.<rank>`` JSON files under the rendezvous dir.  Writes
    are atomic (tmp + rename) so a reader never sees a torn entry; a
    missing/corrupt file reads as 'no entry' (= running), which the
    analysis treats as able-to-progress — crash-safe in the direction
    that never false-positives.

    Scaling: a naive ``read_all`` is O(P)
    file read+parse per check slice, which at O(100) ranks puts real
    I/O on every stalled wait's 0.25s cadence.  Readers therefore keep
    a compacted ``pending.summary.json`` beside the per-rank files:
    ``read_all`` stats each per-rank file (cheap) and re-reads ONLY the
    ones whose ``(mtime_ns, size)`` identity moved past the summary's
    record — AND any file touched within the last ``_MTIME_TRUST_S``,
    because on a coarse-mtime filesystem two distinct publishes inside
    one mtime tick with equal sizes would alias, and serving the stale
    stamps could CONFIRM a false deadlock (the one direction this board
    must never err).  A genuinely stalled rank republishes every check
    slice, so 'recently touched' ≈ 'the blocked ranks': the compaction
    still saves the parses for the quiet majority.  Each ``publish``
    stamps a per-rank monotonic ``_seq`` into the entry as forensic
    ordering evidence.  A stale or corrupt summary only costs fallback
    reads — correctness never depends on it.

    Compaction is SERIALIZED behind ``pending.summary.lock`` (atomic
    ``O_EXCL`` create; stale locks from a reader that died mid-
    compaction are taken over past ``_LOCK_STALE_S``): the summary used
    to be last-writer-wins, so N concurrently-stalled readers would
    each redo the same fallback reads and overwrite each other's
    compactions.  Now exactly one reader compacts at a time; a reader
    that loses the lock race RELOADS the holder's freshly-written
    summary instead of re-parsing unchanged files, performs only the
    fallback reads correctness still requires (its dirtiness is
    remembered and flushed under the lock on a later slice), and never
    writes.  Lock unavailability can only ever cost duplicate reads —
    never a wrong entry."""

    SUMMARY = "pending.summary.json"
    LOCK = "pending.summary.lock"
    # a compaction lock untouched this long belongs to a dead reader
    # (a live one holds it for one json dump); take it over
    _LOCK_STALE_S = 5.0
    # Cache-trust horizon: a file whose mtime is younger than this is
    # always re-read (coarse-mtime aliasing guard, see class docstring).
    # Must STRICTLY exceed the worst plausible mtime granularity (1-2s
    # on ext3/NFS/FAT-class filesystems): mtimes floor DOWN, so a file
    # can look up to one granule older than its newest write — only an
    # apparent age past granularity + margin proves its mtime granule
    # is really over and no same-identity rewrite can still be hiding.
    _MTIME_TRUST_S = 2.5

    def __init__(self, rdv_dir: str, rank: int, size: int) -> None:
        self._rdv = rdv_dir
        self._rank = rank
        self._size = size
        self._seq = 0
        # summary cache: rank(str) -> {"id": [mtime_ns, size, seq],
        # "entry": {...}}; loaded lazily from SUMMARY, refreshed on use
        self._cache: Dict[str, dict] = {}
        self._cache_loaded = False
        self._dirty = False  # cache moved past the on-disk summary
        self.fallback_reads = 0   # test/tool introspection
        self.summary_writes = 0   # compactions this reader performed
        self.lock_takeovers = 0   # stale locks reclaimed

    def _path(self, rank: int) -> str:
        return os.path.join(self._rdv, f"pending.{rank}")

    def publish(self, rank: int, entry: Optional[dict]) -> None:
        path = self._path(rank)
        try:
            if entry is None:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
                return
            self._seq += 1
            entry = dict(entry)
            entry["_seq"] = self._seq
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(entry, f)
            os.replace(tmp, path)
        except OSError:
            pass  # rendezvous dir tearing down — world is exiting

    def _load_summary(self, force: bool = False) -> None:
        if self._cache_loaded and not force:
            return
        self._cache_loaded = True
        try:
            with open(os.path.join(self._rdv, self.SUMMARY)) as f:
                data = json.load(f)
            if isinstance(data, dict):
                loaded = {
                    r: rec for r, rec in data.items()
                    if isinstance(rec, dict) and "id" in rec
                    and "entry" in rec}
                if force:
                    # adopting a CONCURRENT compactor's summary: merge —
                    # keep whichever record is newer per rank (ours may
                    # hold a fallback read the holder hasn't seen)
                    for r, rec in loaded.items():
                        mine = self._cache.get(r)
                        if mine is None or mine["id"][:2] < rec["id"][:2]:
                            self._cache[r] = rec
                else:
                    self._cache = loaded
        except (OSError, ValueError):
            if not force:
                self._cache = {}  # absent/corrupt summary = just fall back

    # -- compaction lock ---------------------------------------------------

    def _lock_path(self) -> str:
        return os.path.join(self._rdv, self.LOCK)

    def _try_lock(self) -> bool:
        """One non-blocking attempt on the compaction lock, with
        stale-lock takeover: unlink a lock whose mtime is past
        _LOCK_STALE_S and retry the O_EXCL create ONCE — two racing
        takeovers both unlink (idempotent) and the create arbitrates."""
        path = self._lock_path()
        for attempt in (0, 1):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                             0o600)
            except FileExistsError:
                if attempt:
                    return False
                import time

                try:
                    if time.time() - os.stat(path).st_mtime \
                            < self._LOCK_STALE_S:
                        return False
                    os.unlink(path)
                    self.lock_takeovers += 1
                except OSError:
                    return False  # vanished/unreadable: holder is live
                continue
            except OSError:
                return False  # rendezvous dir tearing down
            with os.fdopen(fd, "w") as f:
                f.write(f"{os.getpid()}.{self._rank}")
            return True
        return False  # pragma: no cover - loop always returns

    def _unlock(self) -> None:
        path = self._lock_path()
        try:
            # ownership check: if WE were descheduled past the stale
            # bound mid-compaction, another reader legitimately took
            # the lock over — unlinking ITS lock would re-enable the
            # concurrent-writer races this lock exists to prevent.
            # (A check-then-unlink window remains; it requires TWO
            # takeovers inside one scheduling gap — accepted.)
            with open(path) as f:
                if f.read() != f"{os.getpid()}.{self._rank}":
                    return
            os.unlink(path)
        except OSError:
            pass

    def _read_entry(self, path: str) -> Optional[dict]:
        self.fallback_reads += 1
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None  # mid-replace / torn dir: treat as no entry

    def _cache_hit(self, r: int, st, now: float) -> Optional[dict]:
        """The summary record for rank ``r`` iff it is trustworthy:
        identity unchanged AND outside the mtime-aliasing horizon."""
        rec = self._cache.get(str(r))
        if (rec is not None
                and rec["id"][:2] == [st.st_mtime_ns, st.st_size]
                and now - st.st_mtime_ns / 1e9 >= self._MTIME_TRUST_S):
            return dict(rec["entry"])
        return None

    def _scan_pending(self) -> Dict[int, os.stat_result]:
        """One ``os.scandir`` pass over the rendezvous dir → rank ->
        stat of its ``pending.<rank>`` file.  The per-rank ``os.stat``
        loop this replaces cost O(P) path lookups per check slice —
        mostly ENOENT misses, because running ranks have NO pending
        file; one directory read finds exactly the files that exist.  The
        summary/lock/tmp siblings fail the integer-suffix test and are
        skipped; a file vanishing between scandir and DirEntry.stat
        reads as 'no entry', same as before."""
        found: Dict[int, os.stat_result] = {}
        try:
            with os.scandir(self._rdv) as it:
                for de in it:
                    suffix = de.name[8:] if de.name.startswith("pending.") \
                        else ""
                    if not suffix.isdigit():
                        continue
                    r = int(suffix)
                    if 0 <= r < self._size:
                        try:
                            found[r] = de.stat()
                        except OSError:
                            pass  # vanished mid-scan: no entry
        except OSError:
            pass  # rendezvous dir tearing down: everything reads absent
        return found

    def read_all(self) -> Dict[int, dict]:
        import time

        self._load_summary()
        now = time.time()
        out: Dict[int, dict] = {}
        stats = self._scan_pending()
        need: List[int] = []
        for r in range(self._size):
            st = stats.get(r)
            if st is None:
                if self._cache.pop(str(r), None) is not None:
                    self._dirty = True
                continue
            entry = self._cache_hit(r, st, now)
            if entry is not None:
                out[r] = entry
            else:
                need.append(r)
        locked = False
        if need or self._dirty:
            locked = self._try_lock()
            if not locked and need:
                # a concurrent reader is compacting: adopt whatever it
                # already wrote instead of redoing its fallback reads —
                # only ranks the fresh summary STILL cannot answer get
                # parsed here
                self._load_summary(force=True)
                still: List[int] = []
                for r in need:
                    entry = self._cache_hit(r, stats[r], now)
                    if entry is None:
                        still.append(r)
                    else:
                        out[r] = entry
                need = still
        try:
            for r in need:
                entry = self._read_entry(self._path(r))
                if entry is None:
                    continue
                st = stats[r]
                new_rec = {
                    "id": [st.st_mtime_ns, st.st_size,
                           entry.get("_seq", 0)],
                    "entry": entry}
                # recency re-reads of an UNCHANGED file must not churn
                # the summary — only a moved identity rewrites it
                if self._cache.get(str(r), {}).get("id") != new_rec["id"]:
                    self._dirty = True
                self._cache[str(r)] = new_rec
                out[r] = dict(entry)
            if locked and self._dirty:
                self._write_summary()
                self._dirty = False
        finally:
            if locked:
                self._unlock()
        for r, entry in out.items():
            # wall-clock mtime: the one cross-process-comparable
            # stamp (monotonic clocks don't compare across ranks)
            entry["_age_s"] = max(0.0, now - stats[r].st_mtime_ns / 1e9)
        return out

    def _write_summary(self) -> None:
        path = os.path.join(self._rdv, self.SUMMARY)
        tmp = f"{path}.tmp.{os.getpid()}.{self._rank}"
        try:
            with open(tmp, "w") as f:
                json.dump(self._cache, f)
            os.replace(tmp, path)
            self.summary_writes += 1
        except OSError:
            pass  # rendezvous dir tearing down — summary is best effort


# -- request / buffer lint bookkeeping ---------------------------------------


def buffer_span(arr) -> Optional[Tuple[str, int, int]]:
    """``(device, first byte, one past the last byte)`` of the elements a
    tensor view reaches through its strides (a numpy array through its
    array interface, on ``"cpu"``), or None for a payload with no buffer
    behind it."""
    import torch

    if isinstance(arr, torch.Tensor):
        esize = arr.element_size()
        start = arr.data_ptr()
        if arr.numel() == 0:
            return str(arr.device), start, start
        last = sum((n - 1) * st for n, st in zip(arr.shape, arr.stride()))
        return str(arr.device), start, start + (last + 1) * esize
    try:
        start = int(arr.__array_interface__["data"][0])
        return "cpu", start, start + int(arr.nbytes)
    except (AttributeError, KeyError, TypeError):
        return None



class VInfo:
    """Tracking record of one user-level nonblocking request."""

    __slots__ = ("kind", "rank", "peer", "tag", "site", "wait_count",
                 "world", "buf_key", "reported_leak", "__weakref__")

    def __init__(self, world: "WorldVerify", kind: str, rank: int, peer: int,
                 tag: int, site: str) -> None:
        self.world = world
        self.kind = kind
        self.rank = rank
        self.peer = peer
        self.tag = tag
        self.site = site
        self.wait_count = 0
        self.buf_key: Optional[int] = None
        self.reported_leak = False

    def describe(self) -> str:
        return (f"rank {self.rank}: {self.kind}(peer={self.peer}, "
                f"tag={self.tag}) at {self.site}")

    # called from Request._vnote (communicator.py) on every wait()/test()
    def note(self, completed: bool, blocking: bool) -> None:
        w = self.world
        if blocking:
            self.wait_count += 1
            if self.wait_count == 2 and self.kind != "persistent":
                _mpit.count(verify_double_waits=1)
                report_add(f"double-wait: second wait() on the same "
                           f"request — {self.describe()}")
        if completed:
            w.retire_request(self)


class WorldVerify:
    """Per-rank verifier state (one per transport, like ft.WorldFT):
    the shared board plus every rank-local registry the lints need."""

    def __init__(self, transport, board, stall_timeout_s: float) -> None:
        self.t = transport
        self.board = board
        self.stall_timeout_s = float(stall_timeout_s)
        self.rank = transport.world_rank
        self.size = transport.world_size
        self._lock = threading.Lock()
        self.ops = 0          # completed sends+recvs: the progress stamp
        self.block_id = 0     # increments at every blocking-wait entry
        # threads currently INSIDE a verified blocking wait: while any
        # exist, the rank's board entry belongs to them — the progress
        # engine's on-behalf-of-pollers publication stands down (two
        # publishers alternating entries would flap the stamps and the
        # confirm pass could never close)
        self.active_waiters = 0
        self.published = False
        self._last_check = 0.0
        self._live: set = set()          # VInfos not yet completed/waited
        # live nonblocking buffer ranges:
        # key -> (device, start, end, writes, desc)
        self._bufs: Dict[int, Tuple[str, int, int, bool, str]] = {}
        self._buf_key = 0
        # (ctx-repr, site, kind) of comms created while verifying
        self.comms: Dict[int, Tuple[str, str, bool]] = {}
        self._comm_key = 0
        _WORLDS.add(self)

    # -- progress / board --------------------------------------------------

    def note_progress(self) -> None:
        self.ops += 1
        if self.published:
            self.published = False
            self.board.publish(self.rank, None)

    def clear_published(self) -> None:
        """Retract a published 'blocked' entry without claiming progress
        — the exit path of a stalled wait that raised (RecvTimeout,
        ProcFailedError, RevokedError): the rank is no longer in that
        wait, and a lingering entry could falsely implicate it in a
        peer's wait-for analysis until the TTL expires.  DeadlockError
        deliberately does NOT retract: peers confirming the same
        diagnosis need the entry stable."""
        if self.published:
            self.published = False
            self.board.publish(self.rank, None)

    def begin_block(self) -> int:
        self.block_id += 1
        return self.block_id

    def wait_enter(self) -> None:
        with self._lock:
            self.active_waiters += 1

    def wait_exit(self) -> None:
        with self._lock:
            self.active_waiters -= 1

    def mark_exited(self) -> None:
        """Published when the rank's program returns/finalizes: a peer
        blocked on this rank can then be diagnosed (wait-on-exited) the
        way MUST reports 'waiting for a terminated process'."""
        self.board.publish(self.rank, {"state": "exited", "rank": self.rank})

    # -- request lints -----------------------------------------------------

    def track_request(self, req, kind: str, rank: int, peer: int, tag: int,
                      site: str) -> VInfo:
        info = VInfo(self, kind, rank, peer, tag, site)
        req._vinfo = info
        with self._lock:
            self._live.add(info)
        # finalize objects keep themselves alive until the request dies
        weakref.finalize(req, _request_gc, info)
        return info

    def retire_request(self, info: VInfo) -> None:
        with self._lock:
            self._live.discard(info)
        self.release_buffer(info)

    # -- buffer overlap lint (the message-race case) -----------------------

    def buffer_live(self, arr, desc: str, writes: bool) -> Optional[int]:
        """Register a buffer as live under a pending nonblocking op;
        returns the release key.  Overlap with another live range on the
        same device where either side WRITES is the message race MUST
        flags."""
        span = buffer_span(arr)
        if span is None:
            return None  # not a buffer-backed payload: nothing to race on
        dev, start, end = span
        if writes:
            # a write-mode registration means a pending op WILL mutate
            # this region: a resilient link still retaining it by
            # reference must snapshot first (bufpool.py)
            _bufpool.touch(arr)
        with self._lock:
            for (d_, s, e, w, d) in self._bufs.values():
                if d_ == dev and s < end and start < e and (w or writes):
                    _mpit.count(verify_buffer_overlaps=1)
                    report_add(
                        f"overlapping live buffers across pending "
                        f"nonblocking ops (message race): {desc} overlaps "
                        f"{d} (bytes [{max(s, start)}, {min(e, end)}) on "
                        f"{dev})")
                    break
            self._buf_key += 1
            self._bufs[self._buf_key] = (dev, start, end, writes, desc)
            return self._buf_key

    def buffer_release(self, key: Optional[int]) -> None:
        if key is None:
            return
        with self._lock:
            self._bufs.pop(key, None)

    def track_buffer(self, info: VInfo, arr, desc: str, writes: bool) -> None:
        info.buf_key = self.buffer_live(arr, desc, writes)

    def release_buffer(self, info: VInfo) -> None:
        self.buffer_release(info.buf_key)
        info.buf_key = None

    # -- unfreed-communicator lint ----------------------------------------

    def track_comm(self, comm, how: str, site: str) -> int:
        with self._lock:
            self._comm_key += 1
            key = self._comm_key
            self.comms[key] = (repr(comm._ctx), site, how)
        return key

    def free_comm(self, key: int) -> None:
        with self._lock:
            self.comms.pop(key, None)

    # -- finalize sweep ----------------------------------------------------

    def finalize_sweep(self) -> None:
        """Fold every still-pending lint into the report: live requests
        never waited, communicators never freed.  Each finding is
        reported ONCE (the registries drain), so repeated sweeps — one
        per test, say — never re-report old findings."""
        with self._lock:
            live = list(self._live)
            self._live.clear()
            comms = list(self.comms.values())
            self.comms.clear()
        for info in live:
            if info.wait_count == 0 and not info.reported_leak:
                info.reported_leak = True
                _mpit.count(verify_requests_leaked=1)
                report_add(f"leaked request (never waited/tested): "
                           f"{info.describe()}")
        for ctx, site, how in comms:
            _mpit.count(verify_comms_unfreed=1)
            report_add(f"rank {self.rank}: communicator from {how}() at "
                       f"{site} (ctx={ctx}) never freed before finalize")


class CommVerify:
    """Per-communicator verifier state: the shared WorldVerify plus this
    communicator's collective sequence counter (the matching check's
    ordering evidence) and, for split/dup children, the unfreed-comm
    registry key."""

    __slots__ = ("world", "_seq", "_seq_lock", "comm_key")

    def __init__(self, world: WorldVerify) -> None:
        self.world = world
        self._seq = 0
        self._seq_lock = threading.Lock()
        self.comm_key: Optional[int] = None

    def next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq


def _request_gc(info: VInfo) -> None:
    """weakref.finalize callback: the request object was garbage
    collected.  An unwaited request at GC is the leak MUST flags —
    isend/irecv whose completion nobody ever observed."""
    if info.wait_count == 0 and not info.reported_leak:
        info.reported_leak = True
        _mpit.count(verify_requests_leaked=1)
        report_add(f"leaked request (garbage-collected without wait/test): "
                   f"{info.describe()}")
    info.world.retire_request(info)


def finalize_report() -> List[str]:
    """Sweep every live verifier world's pending lints into the report,
    then drain it — the finalize-time report (called by
    ``mpi_tpu_torch.finalize()``; tests call it directly)."""
    for world in list(_WORLDS):
        world.finalize_sweep()
    return take_report()
