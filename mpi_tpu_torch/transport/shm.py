"""Shared-memory transport — the port's own copy of
``mpi_tpu/transport/shm.py``: the per-pair SPSC rings and futex doorbells
of ``native/shmring.cpp`` (:140-205), inline progress with the helper
drainer (:206-440), readiness stamps and epochs (:471-530, :860-945) and
the teardown (:947).

One native SPSC byte ring in POSIX shared memory per directed rank pair,
no syscalls on the data path.  Frames are ``<u64 flags|length>`` + body;
the body is a pickle envelope or a raw frame (``codec.py``: meta, then
the tensor bytes, never pickled).  Every rank CREATES its P-1 incoming
rings and one futex doorbell (stale segments unlinked first) and stamps
its readiness file in the rendezvous directory with its membership
epoch; senders open the peer's ring and doorbell on first send, after
the stamp shows an acceptable epoch.  Whichever thread blocks in
``recv``/``probe`` drains the rings itself, sleeping on the doorbell when
they are empty; a helper thread drains at 20 Hz when no thread of the
rank receives (two ranks exchanging frames larger than the ring).

Tensors stay where they live.  A CPU tensor's bytes go from its memory
into the ring and from the ring into the receiving tensor's memory.  A
CUDA tensor is staged into host memory by a blocking copy before its
frame is written (``codec.stage``); a received frame is read into host
buffers and copied to this transport's ``device`` — or, when the frame
pairs with a posted receive of the collective engine (``recvpool.py``),
into that receive's destination view.

Segment names: ``/mtt_<session>_...`` (:func:`shm_prefix`), where the
session is the rendezvous directory's basename.  The reference's
segments are ``/mt_<session>_...``, so neither package's crash cleanup or
stale-segment unlink can touch the other's.

:func:`run_shm` runs ``fn(comm)`` on P rank threads of one process, each
with its own ``ShmTransport`` over real shared memory: the rings, the
doorbells and the arena are exercised exactly as between processes.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import shutil
import struct
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import bufpool as _bufpool
from .. import mpit as _mpit
from .. import recvpool as _recvpool
from .. import telemetry as _telemetry
from ..errors import EpochSkewError
from ..native import load_shmring
from . import codec
from .base import Transport, TransportError

_LEN = struct.Struct("<Q")
_LEN_MASK = codec.RAW_FLAG - 1
_RING_BYTES = 4 << 20  # per-pair ring (the ``ring_bytes=`` argument)
_OPEN_TIMEOUT = 60.0
# max time with NO progress before declaring a peer dead (cvar
# shm_write_timeout_s)
_WRITE_TIMEOUT = 120.0
_PROGRESS_SLICE = 0.25  # max doorbell nap; re-checks deadline/closing
_SMALL = 8192  # frames up to this commit in one ring write (one bell)
# bounded poll-spin before the futex nap, on with >= 2 CPUs
_SPIN_S = 100e-6 if (os.cpu_count() or 1) > 1 else 0.0
# grace before an ahead-of-us readiness stamp is declared a skew (cvar
# epoch_grace_s, shared with the socket transport)
_EPOCH_GRACE_S = 2.0


class _PeerDeadMidFrame(TransportError):
    """A frame from ``src`` truncated because the failure detector
    declared the sender dead: that one channel is quarantined, the rest
    of the transport stays healthy."""

    def __init__(self, msg: str, src: int) -> None:
        super().__init__(msg)
        self.src = src


def _addr(buf) -> int:
    """Raw address of a host buffer (a contiguous CPU tensor or a
    bytes-like); the caller keeps ``buf`` alive across the native call."""
    if isinstance(buf, torch.Tensor):
        return buf.data_ptr()
    return np.frombuffer(buf, dtype=np.uint8).ctypes.data


def _nbytes(buf) -> int:
    if isinstance(buf, torch.Tensor):
        return buf.numel() * buf.element_size()
    return memoryview(buf).nbytes


def _host_bytes(buf) -> bytes:
    if isinstance(buf, torch.Tensor):
        return bytes(_bufpool.byte_view(buf)) if buf.numel() else b""
    return bytes(buf)


def shm_prefix(session: str) -> str:
    """Common /dev/shm name prefix of every segment of one session (the
    launcher's crash-path cleanup globs on it)."""
    return f"mtt_{session}_"


def _ring_name(session: str, src: int, dst: int) -> bytes:
    return f"/{shm_prefix(session)}{src}_{dst}".encode()


def _db_name(session: str, rank: int) -> bytes:
    return f"/{shm_prefix(session)}db_{rank}".encode()


class ShmTransport(Transport):
    # 256 KiB segments x window 4 = a quarter of the 4 MiB ring: the
    # engine's in-flight credit stays well inside it
    coll_segment_hint = 256 << 10

    # communicators over this transport may map a collective arena
    # (coll_sm.py); the handles register in _coll_arenas, close() tears
    # them down
    supports_coll_sm = True

    # tuned-dispatch table key (tuning/)
    tuning_transport = "shm"

    def __init__(self, rank: int, size: int, rdv_dir: str,
                 ring_bytes: int = _RING_BYTES,
                 connect_timeout: float = _OPEN_TIMEOUT,
                 epoch: int = 0, device=None, verify_clock=None) -> None:
        super().__init__(rank, size, device)
        self.epoch = epoch  # a rejoiner is born into the current epoch
        # the verifier's vector clock exists before any frame is read
        self.verify_clock = self.mailbox.clock = verify_clock
        self._lib = load_shmring()
        self._session = os.path.basename(rdv_dir.rstrip("/"))
        self._rdv = rdv_dir
        self._connect_timeout = connect_timeout
        self._ring_bytes = ring_bytes
        self._closing = False
        # inbound channels quarantined mid-frame (sender died half-way)
        self._dead_srcs: set = set()
        # rendezvous steering: the ring is a reliable in-order stream, so
        # each frame is the next fresh frame of the current generation;
        # seq counts, gen bumps when membership_invalidate recreates a
        # ring.  Touched only under the progress lock.
        self.recv_registry = _recvpool.PostedRecvRegistry()
        self._rx_seq: Dict[int, int] = {}
        self._rx_gen: Dict[int, int] = {}
        self._in_rings: Dict[int, int] = {}
        self._db = None
        self._helper = None
        try:
            for src in range(size):
                if src == rank:
                    continue
                name = _ring_name(self._session, src, rank)
                ring = self._lib.shmring_create(name, ring_bytes)
                if not ring:
                    raise TransportError(
                        f"rank {rank}: shmring_create({name!r}) failed")
                self._in_rings[src] = ring
            self._db = self._lib.shmdb_create(_db_name(self._session, rank))
            if not self._db:
                raise TransportError(f"rank {rank}: doorbell create failed")
        except BaseException:
            self._unlink_own()
            raise
        self._in_items = list(self._in_rings.items())
        self._write_readiness()
        self._out_rings: Dict[int, int] = {}
        self._out_dbs: Dict[int, int] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._state_lock = threading.Lock()
        # exactly one thread runs the progress engine at a time
        self._progress_lock = threading.Lock()
        self._user_waiters = 0  # user threads inside _blocking_match
        self._waiters_lock = threading.Lock()
        self._helper = threading.Thread(
            target=self._helper_loop, name=f"mpi-tpu-torch-shm-helper-{rank}",
            daemon=True)
        self._helper.start()

    # -- progress engine (incoming) ----------------------------------------

    def _helper_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._closing:
            # last-resort drainer only: a receiving user thread owns the
            # progress engine; the helper polls at 20 Hz and never waits
            # on the doorbell (that would wake an extra thread per frame)
            time.sleep(0.05)
            if self._closing:
                return
            if (self._user_waiters == 0
                    and self._progress_lock.acquire(blocking=False)):
                try:
                    if self._closing:
                        return
                    if self._user_waiters == 0:
                        self._drain_once()
                except TransportError:
                    return  # the mailbox carries the diagnosis
                finally:
                    self._progress_lock.release()

    def _read_exact(self, ring: int, addr: int, n: int, src: int) -> None:
        """Stream exactly ``n`` bytes from ``ring`` to ``addr`` in short
        native slices, so teardown and a dead peer are noticed promptly.
        Caller holds the progress lock and keeps the buffer alive."""
        done = 0
        stall = time.monotonic() + _WRITE_TIMEOUT
        while done < n:
            got = self._lib.shmring_read_some(
                ring, addr + done, n - done, _PROGRESS_SLICE)
            if got:
                done += got
                stall = time.monotonic() + _WRITE_TIMEOUT
                continue
            if self._closing:
                raise TransportError(
                    f"rank {self.world_rank}: transport closed mid-frame "
                    f"from {src}")
            if self._peer_suspected(src):
                raise _PeerDeadMidFrame(
                    f"rank {self.world_rank}: frame from {src} truncated "
                    f"mid-stream: the failure detector declared rank "
                    f"{src} dead", src)
            if time.monotonic() > stall:
                self.mailbox.close()  # failure must reach blocked recvs
                raise TransportError(
                    f"rank {self.world_rank}: truncated frame from {src} "
                    f"(no data for {_WRITE_TIMEOUT}s — is the sender alive?)")

    def _read_into(self, ring: int, dests: Sequence[Any], src: int) -> None:
        """Stream ring bytes into host destinations (tensors or ndarrays)."""
        for a in dests:
            if isinstance(a, torch.Tensor):
                ptr, n = a.data_ptr(), a.numel() * a.element_size()
            else:
                ptr, n = a.ctypes.data, a.nbytes
            if n:
                self._read_exact(ring, ptr, n, src)

    def _note_counted(self, src: int, ctx, tag: int, plan):
        """Count one in-order frame on its steering channel (internal tags
        always, user tags once an ``irecv(buf=...)`` activated the
        channel, ``mpi_tpu/transport/shm.py:293``); returns the posted
        destination to steer into, or None.  Caller holds the progress
        lock."""
        reg = self.recv_registry
        if tag >= 0 and not (reg.user_count
                             and reg.user_active(src, ctx, tag)):
            return None
        seq = self._rx_seq.get(src, 0) + 1
        self._rx_seq[src] = seq
        return self.recv_registry.note_frame(src, ctx, tag, seq,
                                             self._rx_gen.get(src, 0), plan)

    def _read_frame(self, src: int, ring: int) -> Tuple[Any, int, Any, Any]:
        """Read one complete frame (its header is known present): (ctx,
        tag, payload, vclock stamp or None).  Small frames take two native
        calls (header, whole body); large raw frames stream into their
        destination tensors."""
        hdr = ctypes.create_string_buffer(_LEN.size)
        self._read_exact(ring, ctypes.addressof(hdr), _LEN.size, src)
        (word,) = _LEN.unpack(hdr.raw)
        body = word & _LEN_MASK
        vc = self.verify_clock
        stamp = None
        try:
            if word & codec.RAW_FLAG:
                if body <= _SMALL:
                    buf = ctypes.create_string_buffer(body)
                    self._read_exact(ring, ctypes.addressof(buf), body, src)
                    ctx, tag, out = codec.parse_raw_body(buf.raw, self.device)
                    if vc is not None:
                        ctx, stamp = vc.unwrap(ctx)
                    # small frames never steer but still count, so the
                    # frame/consumer pairing stays aligned
                    self._note_counted(src, ctx, tag, None)
                    return ctx, tag, out, stamp
                mbuf = ctypes.create_string_buffer(codec.META.size)
                self._read_exact(ring, ctypes.addressof(mbuf),
                                 codec.META.size, src)
                (mlen,) = codec.META.unpack(mbuf.raw)
                meta = ctypes.create_string_buffer(mlen)
                self._read_exact(ring, ctypes.addressof(meta), mlen, src)
                ctx, tag, plan = codec.parse_raw_meta(meta.raw)
                if vc is not None:
                    # unwrap before the steering consult: the registry
                    # keys on the real ctx
                    ctx, stamp = vc.unwrap(ctx)
                total = codec.plan_nbytes(plan)
                if codec.META.size + mlen + total != body:
                    raise ValueError(
                        f"raw frame length mismatch: header says {body}, "
                        f"meta implies {codec.META.size + mlen + total}")
                out = self._note_counted(src, ctx, tag, plan)
                rec = _telemetry.REC
                if out is not None:
                    # copy-on-write any retained frame still referencing
                    # the destination BEFORE writing it
                    hosts, staged = _recvpool.steer_targets(out)
                    for d in hosts:
                        _bufpool.touch(d)
                    ok = False
                    try:
                        try:
                            # host destinations take the ring bytes in
                            # place, card ones through pinned staging
                            self._read_into(ring, hosts, src)
                            ok = True
                        finally:
                            _recvpool.finish_steer(staged, ok)
                    except BaseException:
                        # torn mid-steer or a failed copy: the destination
                        # never reaches the mailbox, the owner's fallback
                        # refill overwrites the partial bytes
                        if tag >= 0:
                            self.recv_registry.steer_abort(out)
                        raise
                    if tag >= 0:
                        self.recv_registry.steer_done(out)
                    _mpit.count(recv_pool_rendezvous=1,
                                recv_bytes_steered=total)
                    if rec is not None:
                        rec.emit("recvpool", "steer",
                                 attrs={"src": src, "tag": tag,
                                        "nbytes": total, "transport": "shm"})
                    return ctx, tag, out, stamp
                host = codec.alloc_raw(plan, self.device)
                try:
                    self._read_into(ring, host, src)
                except BaseException:
                    if self.device.type != "cpu":
                        for h in host:
                            _recvpool.RECV_POOL.give_back(h)
                    raise
                return ctx, tag, codec.finish_raw(plan, host, self.device), \
                    stamp
            payload = ctypes.create_string_buffer(body) if body else None
            if body:
                self._read_exact(ring, ctypes.addressof(payload), body, src)
            ctx, tag, obj = pickle.loads(payload.raw if body else b"")
            if vc is not None:
                ctx, stamp = vc.unwrap(ctx)
            self._note_counted(src, ctx, tag, None)
            return ctx, tag, obj, stamp
        except TransportError:
            raise
        except Exception as e:  # noqa: BLE001 - deliver the diagnosis
            self.mailbox.close()
            raise TransportError(
                f"rank {self.world_rank}: bad frame from {src}: {e}")

    def _drain_once(self) -> bool:
        """Pull every started frame out of the rings into the Mailbox;
        True if anything was delivered.  Caller holds the progress lock."""
        lib = self._lib
        progressed = False
        for src, ring in self._in_items:
            if src in self._dead_srcs:
                continue  # desynced channel, until an epoch transition
            try:
                while lib.shmring_avail(ring) >= _LEN.size:
                    ctx, tag, obj, stamp = self._read_frame(src, ring)
                    self.mailbox.deliver(src, ctx, tag, obj, stamp)
                    progressed = True
            except _PeerDeadMidFrame:
                self._dead_srcs.add(src)
                continue
        if progressed:
            # threads that lost the progress-lock race wait on the bell
            self._lib.shmdb_ring(self._db)
        return progressed

    def _progress_wait(self, slice_s: float) -> None:
        """One blocking progress step: snapshot the bell, drain, spin
        briefly, nap on the bell, drain again (seqlock order: a frame
        landing between scan and nap still wakes us).  Caller holds the
        progress lock and checked ``_closing`` after acquiring it."""
        lib = self._lib
        seen = lib.shmdb_read(self._db)
        if self._drain_once():
            return
        if _SPIN_S > 0.0:
            spin_deadline = time.monotonic() + min(_SPIN_S, slice_s)
            while time.monotonic() < spin_deadline:
                os.sched_yield()
                if self._drain_once():
                    return
                if self._closing:
                    return
        lib.shmdb_wait(self._db, seen, slice_s)
        self._drain_once()

    def _blocking_match(self, op: str, source: int, ctx, tag: int,
                        timeout: Optional[float],
                        consume: bool) -> Tuple[Any, int, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._waiters_lock:
            self._user_waiters += 1
        try:
            return self._match_loop(op, source, ctx, tag, timeout, deadline,
                                    consume)
        finally:
            with self._waiters_lock:
                self._user_waiters -= 1

    def _match_loop(self, op, source, ctx, tag, timeout, deadline, consume):
        from .base import RecvTimeout

        while True:
            if consume:
                hit = self.mailbox.poll(source, ctx, tag)
            else:
                pk = self.mailbox.peek_nowait(source, ctx, tag)
                hit = None if pk is None else (pk[2], pk[0], pk[1])
            if hit is not None:
                return hit
            if self._closing:
                raise TransportError(
                    f"transport closed while waiting for {op}"
                    f"(source={source}, ctx={ctx}, tag={tag})")
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                raise RecvTimeout(
                    f"{op}(source={source}, ctx={ctx}, tag={tag}) timed out "
                    f"after {timeout}s; pending={self.mailbox.pending_summary()}")
            slice_s = _PROGRESS_SLICE
            if remaining is not None:
                slice_s = min(slice_s, remaining)
            if self._progress_lock.acquire(blocking=False):
                try:
                    if self._closing:
                        continue
                    self._progress_wait(slice_s)
                finally:
                    self._progress_lock.release()
            else:
                # another thread holds the progress engine: wait on the
                # doorbell, which rings on remote arrival and on local
                # delivery alike
                if self._closing:
                    continue
                seen = self._lib.shmdb_read(self._db)
                if consume:
                    hit = self.mailbox.poll(source, ctx, tag)
                    if hit is not None:
                        return hit
                else:
                    pk = self.mailbox.peek_nowait(source, ctx, tag)
                    if pk is not None:
                        return pk[2], pk[0], pk[1]
                self._lib.shmdb_wait(self._db, seen, slice_s)

    def progress_park(self, timeout: float) -> bool:
        """Progress-engine park (``progress.py``): one drain pass under
        the progress lock, then a nap on the doorbell with the lock
        RELEASED (a user receiver arriving mid-park takes the engine
        inline).  True iff anything was delivered."""
        if self._closing:
            raise TransportError(
                f"rank {self.world_rank}: transport closed while parked")
        before = self.mailbox.deliveries
        seen = self._lib.shmdb_read(self._db)
        drained = False
        if (self._user_waiters == 0
                and self._progress_lock.acquire(blocking=False)):
            try:
                if self._closing:
                    raise TransportError(
                        f"rank {self.world_rank}: transport closed while "
                        f"parked")
                drained = self._drain_once()
            finally:
                self._progress_lock.release()
        if not drained and self.mailbox.deliveries == before:
            if _SPIN_S > 0.0:
                spin_deadline = time.monotonic() + min(_SPIN_S, timeout)
                while (time.monotonic() < spin_deadline
                       and not self._closing
                       and self._lib.shmdb_read(self._db) == seen):
                    os.sched_yield()
            if (not self._closing
                    and self._lib.shmdb_read(self._db) == seen):
                self._lib.shmdb_wait(self._db, seen, timeout)
            if (self._user_waiters == 0
                    and self._progress_lock.acquire(blocking=False)):
                try:
                    if not self._closing:
                        self._drain_once()
                finally:
                    self._progress_lock.release()
        return self.mailbox.deliveries != before

    # -- Transport interface (incoming) ------------------------------------

    def recv(self, source: int, ctx, tag: int,
             timeout: Optional[float] = None) -> Tuple[Any, int, int]:
        return self._blocking_match("recv", source, ctx, tag, timeout, True)

    def _try_drain(self) -> None:
        if self._progress_lock.acquire(blocking=False):
            try:
                if not self._closing:
                    self._drain_once()
            finally:
                self._progress_lock.release()

    def poll(self, source: int, ctx, tag: int):
        self._try_drain()
        return self.mailbox.poll(source, ctx, tag)

    def peek(self, source: int, ctx, tag: int,
             timeout: Optional[float] = None):
        n, s, t = self._blocking_match("probe", source, ctx, tag, timeout,
                                       False)
        return s, t, n

    def peek_nowait(self, source: int, ctx, tag: int):
        self._try_drain()
        return self.mailbox.peek_nowait(source, ctx, tag)

    # -- outgoing ----------------------------------------------------------

    def _send_lock(self, dest: int) -> threading.Lock:
        with self._state_lock:
            if self._closing:
                raise TransportError(
                    f"rank {self.world_rank}: send on a closed transport")
            lock = self._send_locks.get(dest)
            if lock is None:
                lock = self._send_locks[dest] = threading.Lock()
            return lock

    def _peer_epoch_once(self, dest: int) -> Optional[int]:
        """Epoch stamped in the peer's readiness file, None when not yet
        published."""
        try:
            with open(os.path.join(self._rdv, f"shm.{dest}")) as f:
                text = f.read().strip()
        except OSError:
            return None
        try:
            return int(text)
        except ValueError:
            return 0

    def _out_ring_locked(self, dest: int) -> int:
        with self._state_lock:
            ring = self._out_rings.get(dest)
        if ring is not None:
            return ring
        # wait for the peer's incoming rings at an acceptable epoch: newer
        # than ours past the grace = we were shrunk out (EpochSkewError);
        # below min_peer_epoch[dest] = a replaced slot's stale file (keep
        # polling for the rejoiner's republish)
        need = self.min_peer_epoch.get(dest, 0)
        deadline = time.monotonic() + self._connect_timeout
        skew_since = None
        while True:
            fe = self._peer_epoch_once(dest)
            if fe is not None:
                if fe > self.epoch:
                    if skew_since is None:
                        skew_since = time.monotonic()
                    if time.monotonic() - skew_since > _EPOCH_GRACE_S:
                        _mpit.count(epoch_skews=1)
                        raise EpochSkewError(
                            f"rank {self.world_rank}: peer {dest} "
                            f"published shm endpoints at membership "
                            f"epoch {fe}, this process at {self.epoch} "
                            f"— this process was shrunk out of the "
                            f"world (stale-epoch straggler)",
                            local_epoch=self.epoch, peer_epoch=fe,
                            peer=dest)
                elif fe >= need:
                    break
                else:
                    skew_since = None
            if time.monotonic() > deadline:
                raise TransportError(
                    f"rank {self.world_rank}: peer {dest} did not publish "
                    f"shm readiness at epoch >= {need} within "
                    f"{self._connect_timeout}s")
            time.sleep(0.005)
        name = _ring_name(self._session, self.world_rank, dest)
        ring = self._lib.shmring_open(name, self._connect_timeout)
        if not ring:
            raise TransportError(
                f"rank {self.world_rank}: shmring_open({name!r}) failed")
        db = self._lib.shmdb_open(_db_name(self._session, dest),
                                  self._connect_timeout)
        if not db:
            raise TransportError(
                f"rank {self.world_rank}: doorbell open for {dest} failed")
        with self._state_lock:
            self._out_rings[dest] = ring
            self._out_dbs[dest] = db
        return ring

    def send(self, dest: int, ctx, tag: int, payload: Any) -> None:
        if not (0 <= dest < self.world_size):
            raise ValueError(
                f"dest {dest} out of range for world size {self.world_size}")
        if self._closing:
            raise TransportError(
                f"rank {self.world_rank}: send on a closed transport")
        if dest == self.world_rank:
            # counted on its steering channel first (loopback traffic
            # consumes posted slots like any arrival)
            reg = self.recv_registry
            if tag < 0 or (reg.user_count
                           and reg.user_active(dest, ctx, tag)):
                reg.note_local(dest, ctx, tag)
            vc = self.verify_clock
            stamp = vc.tick_send() if vc is not None else None
            self.mailbox.deliver(dest, ctx, tag, codec.value_copy(payload),
                                 stamp)
            # a thread napping on our bell must notice the local delivery
            self._lib.shmdb_ring(self._db)
            return
        vc = self.verify_clock
        if vc is not None:
            ctx = vc.wrap(ctx)  # the stamp rides in the meta's ctx slot
        frame = codec.pack_raw_frame(ctx, tag, payload)
        if frame is not None:
            head, bufs = frame
            body = len(head) + sum(_nbytes(b) for b in bufs)
            header = _LEN.pack(codec.RAW_FLAG | body)
            with self._send_lock(dest):
                if self._closing:
                    raise TransportError(
                        f"rank {self.world_rank}: send on a closed transport")
                ring = self._out_ring_locked(dest)
                if body <= _SMALL:
                    frame = header + head + b"".join(
                        _host_bytes(b) for b in bufs)
                    self._write_all(ring, frame, len(frame), dest)
                    self._lib.shmdb_ring(self._out_dbs[dest])
                    return
                # big frame: header+meta, bell, then each buffer's bytes
                # straight from its memory (see the pickle path for why
                # the bell precedes the body)
                prefix = header + head
                self._write_all(ring, prefix, len(prefix), dest)
                self._lib.shmdb_ring(self._out_dbs[dest])
                for b in bufs:
                    n = _nbytes(b)
                    if n:
                        self._write_all(ring, _addr(b), n, dest)
            return
        blob = codec.pack_pickle_body(ctx, tag, payload)
        with self._send_lock(dest):
            if self._closing:
                raise TransportError(
                    f"rank {self.world_rank}: send on a closed transport")
            ring = self._out_ring_locked(dest)
            if len(blob) <= _SMALL:
                frame = _LEN.pack(len(blob)) + blob
                self._write_all(ring, frame, len(frame), dest)
                self._lib.shmdb_ring(self._out_dbs[dest])
                return
            # header first, then the bell, THEN the body: a frame larger
            # than the ring streams against a live reader, and a body
            # timeout leaves a reader mid-frame rather than an orphaned
            # header
            header = _LEN.pack(len(blob))
            self._write_all(ring, header, len(header), dest)
            self._lib.shmdb_ring(self._out_dbs[dest])
            self._write_all(ring, blob, len(blob), dest)

    def _peer_suspected(self, peer: int) -> bool:
        """True once the fault detector (``ft.py``) declared ``peer``
        dead: both no-progress paths give up within the detection bound."""
        ft = getattr(self, "_ft_world", None)
        return ft is not None and peer in ft.failed

    def _write_all(self, ring: int, buf, n: int, dest: int) -> None:
        """Stream exactly ``n`` bytes into ``ring`` in short native slices.
        ``buf`` is bytes or a raw address; the caller keeps its owner
        alive."""
        done = self._lib.shmring_write_some(ring, buf, n, _PROGRESS_SLICE)
        if done == n:
            return
        addr = buf if isinstance(buf, int) else _addr(buf)
        stall = time.monotonic() + _WRITE_TIMEOUT
        while done < n:
            if self._closing:
                raise TransportError(
                    f"rank {self.world_rank}: transport closed during send "
                    f"to {dest}")
            if self._peer_suspected(dest):
                raise TransportError(
                    f"rank {self.world_rank}: send to {dest} aborted "
                    f"mid-frame ({done}/{n} bytes): the failure detector "
                    f"declared rank {dest} dead (its ring will never "
                    f"drain)")
            if time.monotonic() > stall:
                raise TransportError(
                    f"rank {self.world_rank}: send to {dest} timed out "
                    f"({n} bytes; ring full for {_WRITE_TIMEOUT}s — is the "
                    f"receiver alive?)")
            got = self._lib.shmring_write_some(
                ring, addr + done, n - done, _PROGRESS_SLICE)
            if got:
                done += got
                stall = time.monotonic() + _WRITE_TIMEOUT

    # -- membership (membership.py) ----------------------------------------

    def _write_readiness(self) -> None:
        """Atomically publish ``shm.<rank>`` holding the CURRENT epoch."""
        tmp = os.path.join(self._rdv, f".shm.{self.world_rank}.tmp")
        with open(tmp, "w") as f:
            f.write(str(self.epoch))
        os.replace(tmp, os.path.join(self._rdv, f"shm.{self.world_rank}"))

    def membership_republish(self) -> None:
        """Re-stamp the readiness file with the current epoch after an
        epoch bump: a stale straggler's fresh ring-open reads the skew,
        and a rejoiner waits for it before opening our rings."""
        try:
            self._write_readiness()
        except OSError:
            pass  # rendezvous dir tearing down

    def membership_invalidate(self, dead) -> None:
        """Epoch transition: drop the outgoing rings and doorbells of the
        replaced slots (their segments belong to the dead incarnation),
        and recreate the inbound rings from them (the corpse may have
        died mid-frame) under the progress lock, fencing the steering
        registry to the slot's next stream generation."""
        for dest in dead:
            try:
                lock = self._send_lock(dest)
            except TransportError:
                return  # closing: close() tears everything down
            with lock:
                with self._state_lock:
                    ring = self._out_rings.pop(dest, None)
                    db = self._out_dbs.pop(dest, None)
                if ring is not None:
                    self._lib.shmring_close(ring)
                if db is not None:
                    self._lib.shmdb_close(db)
        with self._progress_lock:
            if self._closing:
                return
            for src in dead:
                src = int(src)
                gen = self._rx_gen.get(src, 0) + 1
                self._rx_gen[src] = gen
                self._rx_seq[src] = 0
                self.recv_registry.purge_src(src, gen)
                old = self._in_rings.pop(src, None)
                if old is None:
                    continue
                self._lib.shmring_close(old)
                ring = self._lib.shmring_create(
                    _ring_name(self._session, src, self.world_rank),
                    self._ring_bytes)
                if ring:
                    self._in_rings[src] = ring
                    self._dead_srcs.discard(src)
            self._in_items = list(self._in_rings.items())

    # -- shutdown ----------------------------------------------------------

    def _unlink_own(self) -> None:
        for src, ring in self._in_rings.items():
            self._lib.shmring_close(ring)
            self._lib.shmring_unlink(
                _ring_name(self._session, src, self.world_rank))
        self._in_rings.clear()
        self._in_items = []
        if self._db:
            self._lib.shmdb_unlink(_db_name(self._session, self.world_rank))

    def close(self) -> None:
        self._closing = True
        # the collective arenas of every communicator over this transport
        # (the creator unlinks the name); arena waits re-check closure
        for arena in list(getattr(self, "_coll_arenas", {}).values()):
            arena.close()
        if self._db:
            self._lib.shmdb_ring(self._db)  # pop any thread out of its nap
        if self._helper is not None and self._helper.is_alive():
            self._helper.join(timeout=2.0)
        # exclude in-flight receivers (progress lock) and senders (every
        # send lock) before unmapping what a memcpy could be streaming into
        with self._state_lock:
            send_locks = list(self._send_locks.values())
        for lock in send_locks:
            lock.acquire()
        try:
            with self._progress_lock:
                with self._state_lock:
                    for ring in self._out_rings.values():
                        self._lib.shmring_close(ring)
                    for db in self._out_dbs.values():
                        self._lib.shmdb_close(db)
                    self._out_rings.clear()
                    self._out_dbs.clear()
                # our doorbell's NAME goes, its one-page mapping stays (a
                # waiter may still be inside shmdb_wait on it)
                self._unlink_own()
        finally:
            for lock in send_locks:
                lock.release()
        self.mailbox.close()


def run_shm(fn: Callable, nranks: int, args: Sequence = (),
            kwargs: Optional[dict] = None, timeout: float = 120.0,
            device=None, ring_bytes: int = _RING_BYTES) -> List[Any]:
    """Run ``fn(comm, *args, **kwargs)`` on ``nranks`` rank threads of
    this process, each over its own :class:`ShmTransport` (real shared
    memory rings, doorbells and arenas); return the per-rank results.
    ``device`` as in ``run_local``: the card when None.  An error on one
    rank is re-raised as ``RuntimeError("rank r failed: ...")`` after
    every transport closed."""
    from ..communicator import P2PCommunicator
    from ..gpu import primitives
    from ..gpu.runner import resolve_device

    device = resolve_device(device)
    kwargs = kwargs or {}
    rdv = tempfile.mkdtemp(prefix="mpi_tpu_torch_shm_")
    results: List[Any] = [None] * nranks
    errors: List[tuple] = []
    transports: List[Optional[ShmTransport]] = [None] * nranks

    def runner(r: int) -> None:
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            primitives.bind_host_rank(r, device)
            t = ShmTransport(r, nranks, rdv, ring_bytes=ring_bytes,
                             device=device)
            transports[r] = t
            comm = P2PCommunicator(t, range(nranks))
            comm._mark_generation()
            results[r] = fn(comm, *args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append((r, e, traceback.format_exc()))
            for t in transports:
                if t is not None:
                    t.mailbox.close()

    threads = [threading.Thread(target=runner, args=(r,),
                                name=f"mpi-tpu-torch-shm-rank-{r}",
                                daemon=True)
               for r in range(nranks)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    stuck = [i for i, t in enumerate(threads) if t.is_alive()]
    for t in transports:
        if t is not None:
            t.close()
    shutil.rmtree(rdv, ignore_errors=True)
    if errors:
        r, e, tb = errors[0]
        raise RuntimeError(f"rank {r} failed:\n{tb}") from e
    if stuck:
        frames = sys._current_frames()
        where = []
        for i in stuck:
            frame = frames.get(threads[i].ident)
            loc = (traceback.extract_stack(frame)[-1]
                   if frame is not None else None)
            where.append(f"rank {i}" + (
                f" at {loc.filename}:{loc.lineno} in {loc.name}"
                if loc is not None else ""))
        raise TimeoutError(
            f"shm ranks did not finish within {timeout}s: {where}")
    return results
