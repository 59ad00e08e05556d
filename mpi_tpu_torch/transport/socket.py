"""TCP socket transport — the port's own copy of
``mpi_tpu/transport/socket.py``, with ``coll_segment_hint = 4 << 20``
(:237) as it is, the epoch-stamped hello and ack (:63-90, :341-390,
:794-900), the peer-fault verdict ``_suspect`` (:756), the idle-link
keepalive ``_keepalive_probe`` (:653), the link-fault hooks of
``transport/faulty.py`` and ``membership_invalidate``; under the runtime
verifier the vector-clock stamp wrapped around the wire ctx (:438, :538,
:1023-1028), the clock attached before the readers start; with the flight
recorder on the frame, torn-frame, reconnect, replay, heal and
injected-reset events (:395-1187); the ``link_heal_s`` histogram is
always fed.

Per-pair TCP connections on loopback.  Wire format per message: a fixed
header ``!QQQ`` = (flags|payload_len, seq, ack) followed by the body —
either a pickle of the envelope ``(ctx, tag, obj)``, or (``RAW_FLAG``
set, see ``codec.py``) a raw frame: a small meta pickle, then the
tensor bytes.  ``seq`` is the per-destination sequence number of the
resilient link (``resilience.py``): the sender retains a bounded window
of unacked frames, the receiver delivers contiguously and drops replays,
and ``ack`` piggybacks the cumulative delivery mark of the REVERSE stream
(a header-only ``_ACK_FLAG`` frame carries it when no data flows the
other way).  A torn connection is rebuilt without losing or duplicating
frames: the hello handshake answers with ``resume(last delivered seq)``
and the sender replays only what the receiver never got.

Tensors stay where they live.  A CUDA tensor is staged into host memory
by a blocking copy before its frame is written (``codec.stage``); a
received frame is read into a pooled host buffer and copied to this
transport's ``device`` — or, when the frame pairs with a posted receive
of the collective engine (``recvpool.py``), copied straight into that
receive's destination view on the card.  On the CPU the bytes go to and
from the tensors' own memory with no staging.

Rank discovery is file-based rendezvous (``membership.py``): each rank
binds an OS-assigned port and publishes it in the rendezvous directory
the launcher (``launcher.py``) provides; peers poll for it.

Membership epochs: the hello carries (rank, epoch) and the acceptor
answers with its own epoch.  A connector that finds a peer at a NEWER
epoch past ``epoch_grace_s`` was shrunk out of the world and raises
``EpochSkewError``; an acceptor refuses a connector below the
``min_peer_epoch`` of its slot (the dead incarnation of a replaced rank).
With fault tolerance on, a send-path fault toward a peer the detector
suspects (``ft.WorldFT.link_suspect``) is a PEER fault, raised at once
instead of healed.  A process that died by ``os._exit`` drops its CUDA
context with it; its survivors only see torn sockets, and no staging
copy waits on the corpse (staging copies a sender's own tensor).
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional, Tuple

from .. import bufpool as _bufpool
from .. import membership as _membership
from .. import mpit as _mpit
from .. import recvpool as _recvpool
from .. import resilience as _resilience
from .. import telemetry as _telemetry
from ..errors import EpochSkewError
from ..resilience import LinkState, backoff_delays
from . import codec
from .base import Transport, TransportError

# Connection handshake: the connector sends (world rank, membership
# epoch), the acceptor answers with ITS epoch and the last sequence number
# it contiguously delivered from this connector (a fresh world answers 0;
# a reconnect prunes the retained window to that mark and replays the
# rest).
_HELLO = struct.Struct("!iq")       # rank, epoch
_HELLO_ACK = struct.Struct("!qQ")   # acceptor's epoch, resume(last delivered)
_HEADER = struct.Struct("!QQQ")     # flags|payload_len, seq, cumulative ack
# Header word bit 62: a standalone cumulative-ack control frame (no body,
# seq 0, outside the sequenced stream).  codec.RAW_FLAG is bit 63, so body
# lengths live in the low 62 bits.
_ACK_FLAG = 1 << 62
_LEN_MASK = _ACK_FLAG - 1
_HOST = "127.0.0.1"
# Grace before a peer's newer epoch is declared a skew: an epoch
# transition is broadcast, and a healthy member may see a peer's new epoch
# a moment before applying its own bump (cvar epoch_grace_s).
_EPOCH_GRACE_S = 2.0

# Ack-flusher cadence: once woken by a pending ack, batch for this long
# before flushing (one control frame for a burst of deliveries); the
# park itself is condition-variable based.
_ACK_BATCH_S = 0.002
_ACK_IDLE_S = 0.25

# Scatter-gather batching: header + meta + body segments go out in ONE
# sendmsg call; Linux caps an iovec at IOV_MAX (1024) entries.
_IOV_MAX = 1024
_HAS_SENDMSG = hasattr(socket.socket, "sendmsg")
_HAS_RECVMSG_INTO = hasattr(socket.socket, "recvmsg_into")


def _sendmsg_views(conn: socket.socket, views) -> None:
    """Stream ``views`` (byte buffers) with vectored ``sendmsg``, looping
    on partial writes; counted in ``link_send_syscalls``."""
    if not _HAS_SENDMSG:  # pragma: no cover - non-sendmsg platform
        for v in views:
            conn.sendall(v)
            _mpit.count(link_send_syscalls=1)
        return
    idx, off = 0, 0
    n = len(views)
    while idx < n:
        if off:
            batch = [memoryview(views[idx])[off:]]
            batch.extend(views[idx + 1:idx + _IOV_MAX])
        else:
            batch = views[idx:idx + _IOV_MAX]
        sent = conn.sendmsg(batch)
        _mpit.count(link_send_syscalls=1)
        while sent > 0:
            rem = memoryview(views[idx]).nbytes - off
            if sent < rem:
                off += sent
                sent = 0
            else:
                sent -= rem
                idx += 1
                off = 0


class _LinkAbort(TransportError):
    """Healing-loop abort (the transport is closing)."""


def _recv_exact2(sock: socket.socket,
                 n: int) -> Tuple[Optional[bytes], bool]:
    """``(data, torn)``: data is None on EOF/error; ``torn`` is True iff
    the stream died MID-READ (a torn frame the link must heal), as
    opposed to a clean between-frames close."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None, len(buf) > 0
        if not chunk:
            return None, len(buf) > 0
        buf += chunk
    return bytes(buf), False


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    return _recv_exact2(sock, n)[0]


def _recvmsg_into_views(sock: socket.socket, views) -> bool:
    """Fill every view in ``views`` completely (vectored ``recvmsg_into``,
    resuming mid-view on partial reads); counted in ``link_recv_syscalls``.
    False on EOF/error (torn frame)."""
    views = [memoryview(v).cast("B") for v in views if memoryview(v).nbytes]
    idx, off = 0, 0
    n = len(views)
    while idx < n:
        if off:
            batch = [views[idx][off:]]
            batch.extend(views[idx + 1:idx + _IOV_MAX])
        else:
            batch = views[idx:idx + _IOV_MAX]
        try:
            if _HAS_RECVMSG_INTO:
                got = sock.recvmsg_into(batch)[0]
            else:  # pragma: no cover - non-recvmsg platform
                got = sock.recv_into(batch[0])
        except OSError:
            return False
        _mpit.count(link_recv_syscalls=1)
        if got == 0:
            return False
        while got > 0:
            rem = views[idx].nbytes - off
            if got < rem:
                off += got
                got = 0
            else:
                got -= rem
                idx += 1
                off = 0
    return True


class SocketTransport(Transport):
    # Loopback TCP gets its exchange overlap from the kernel socket
    # buffers; what segmentation costs it is per-frame host work (header,
    # meta pickle, reader-thread delivery, and on the card one staging
    # copy each way), so it prefers few, large frames.
    coll_segment_hint = 4 << 20
    # tuned-dispatch table key (tuning/)
    tuning_transport = "socket"

    def __init__(self, rank: int, size: int, rdv_dir: str, device=None,
                 connect_timeout: float = 60.0, epoch: int = 0,
                 verify_clock=None) -> None:
        super().__init__(rank, size, device)
        self.epoch = epoch  # a rejoiner is born into the current epoch
        # a verified process world's clock, attached before any reader can
        # see a peer's stamped frame (membership.make_transport)
        self.verify_clock = self.mailbox.clock = verify_clock
        self._rdv = rdv_dir
        self._connect_timeout = connect_timeout
        self._closing = False
        self._send_locks: Dict[int, threading.Lock] = {}
        self._conns: Dict[int, socket.socket] = {}
        self._conn_lock = threading.Lock()
        # inbound connections and their reader threads, closed and joined
        # by close(): a reader must not be inside a torch call when the
        # interpreter finalizes
        self._readers: list = []
        # inbound connections by source rank: membership_invalidate closes
        # a replaced slot's readers, whose captured stream generation just
        # went stale
        self._reader_conns: Dict[int, list] = {}
        self._link = LinkState(size)
        self.recv_registry = _recvpool.PostedRecvRegistry()
        # last data/probe write per destination: what the idle-link
        # keepalive scans
        self._last_send: Dict[int, float] = {}
        # link-fault injection (transport/faulty.py): a callable (dest,
        # stage) fired on the send path, and a countdown of incoming
        # connections the acceptor drops after the hello
        self._link_fault_hook = None
        self._accept_drop_n = 0

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((_HOST, 0))
        self._listener.listen(size + 4)
        _membership.publish_port(rdv_dir, rank,
                                 self._listener.getsockname()[1])
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"mpi-tpu-torch-accept-{rank}",
            daemon=True)
        self._accept_thread.start()
        # Ack flusher: acks ride every data frame for free, but a one-way
        # stream (a gather fan-in) would never ack and the peer's retained
        # window would fill; this daemon flushes standalone ACK frames.
        self._ack_thread = threading.Thread(
            target=self._ack_flush_loop,
            name=f"mpi-tpu-torch-linkack-{rank}", daemon=True)
        self._ack_thread.start()

    # -- incoming ----------------------------------------------------------

    def _accept_loop(self) -> None:
        # accept ONLY; the handshake runs in the per-connection thread so a
        # connector stalled mid-hello never serializes the others
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._handshake_and_read, args=(conn,),
                name=f"mpi-tpu-torch-reader-{self.world_rank}", daemon=True)
            t.start()
            with self._conn_lock:
                self._readers = [(c, r) for c, r in self._readers
                                 if r.is_alive()]
                self._readers.append((conn, t))

    def _handshake_and_read(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello = _recv_exact(conn, _HELLO.size)
            if hello is None:
                conn.close()
                return
            src, peer_epoch = _HELLO.unpack(hello)
            if self._accept_drop_n > 0:
                # injected accept-side drop: vanish without an ack
                self._accept_drop_n -= 1
                conn.close()
                return
            # our epoch FIRST, so a refused stale connector can diagnose
            conn.sendall(_HELLO_ACK.pack(self.epoch,
                                         self._link.delivered(src)))
        except OSError:  # the connector vanished, or close() got here first
            conn.close()
            return
        if peer_epoch < self.min_peer_epoch.get(src, 0):
            # a replaced slot's OLD incarnation dialing in
            _mpit.count(epoch_skews=1)
            conn.close()
            return
        with self._conn_lock:
            conns = self._reader_conns.setdefault(src, [])
            conns[:] = [c for c in conns if c.fileno() >= 0]
            conns.append(conn)
        try:
            # the stream generation, captured: a purge while we read turns
            # every later ack/frame of this connection into a no-op
            self._reader_loop(conn, src, self._link.peer_gen(src))
        finally:
            with self._conn_lock:
                try:
                    self._reader_conns.get(src, []).remove(conn)
                except ValueError:
                    pass

    def _reader_loop(self, conn: socket.socket, src: int, gen: int) -> None:
        while True:
            head, torn = _recv_exact2(conn, _HEADER.size)
            if head is None:
                # link fault or clean close: keep the rx stream state —
                # the sender reconnects and replays unacked frames
                if torn:
                    self._note_torn(src)
                conn.close()
                return
            word, seq, ack = _HEADER.unpack(head)
            if ack:
                self._link.tx_ack(src, ack, gen)
            if word & _ACK_FLAG:
                continue  # header-only control frame
            plen = word & _LEN_MASK
            if word & codec.RAW_FLAG:
                ok, obj_ctx_tag = self._read_raw(conn, src, seq, gen, plen)
                if not ok:
                    self._note_torn(src)
                    conn.close()
                    return
                ctx, tag, out, stamp = obj_ctx_tag
                self._deliver_seq(conn, src, seq, gen, ctx, tag, out, stamp)
                continue
            payload, _ = _recv_exact2(conn, plen)
            if payload is None:
                self._note_torn(src)  # past the header: torn
                conn.close()
                return
            ctx, tag, obj = pickle.loads(payload)
            vc = self.verify_clock
            stamp = None
            if vc is not None:
                ctx, stamp = vc.unwrap(ctx)
            reg = self.recv_registry
            if (tag < 0 or (reg.user_count
                            and reg.user_active(src, ctx, tag))) \
                    and self._link.rx_fresh(src, seq, gen):
                # pickle frames on counted channels still count (never
                # steerable) so the frame/consumer pairing stays aligned
                reg.note_frame(src, ctx, tag, seq, gen, None)
            self._deliver_seq(conn, src, seq, gen, ctx, tag, obj, stamp)

    def _note_torn(self, src: int) -> None:
        """A connection died MID-FRAME: counted (resilience heals it by
        replay, but the class of fault must stay visible)."""
        _mpit.count(link_torn_frames=1)
        rec = _telemetry.REC
        if rec is not None:
            rec.emit("link", "torn_frame", attrs={"src": src})

    def _read_raw(self, conn: socket.socket, src: int, seq: int, gen: int,
                  plen: int):
        """Read one raw frame's meta and body: ``(ok, (ctx, tag, payload,
        stamp))``, ok False on a torn frame.  Under verify the meta's ctx
        is the stamped wrapper, unwrapped before the steering consult
        (the registry keys on the real ctx)."""
        mhead, _ = _recv_exact2(conn, codec.META.size)
        if mhead is None:
            return False, None
        (mlen,) = codec.META.unpack(mhead)
        meta, _ = _recv_exact2(conn, mlen)
        if meta is None:
            return False, None
        ctx, tag, plan = codec.parse_raw_meta(meta)
        vc = self.verify_clock
        stamp = None
        if vc is not None:
            ctx, stamp = vc.unwrap(ctx)
        total = codec.plan_nbytes(plan)
        if codec.META.size + mlen + total != plen:
            # a meta that disagrees with the length word would desync the
            # byte stream: kill the channel and fail loudly
            conn.close()
            raise ValueError(
                f"raw frame length mismatch from rank {src}: header says "
                f"{plen}, meta implies {codec.META.size + mlen + total}")
        # Rendezvous steering: count a FRESH frame of a counted channel
        # (an internal tag, or a user channel an irecv(buf=) activated);
        # a paired posted destination takes the body directly.
        out = None
        reg = self.recv_registry
        if (tag < 0 or (reg.user_count and reg.user_active(src, ctx, tag))) \
                and self._link.rx_fresh(src, seq, gen):
            out = reg.note_frame(src, ctx, tag, seq, gen, plan)
        if out is not None:
            # copy-on-write any retained frame still referencing the
            # destination region BEFORE writing it
            hosts, staged = _recvpool.steer_targets(out)
            for d in hosts:
                _bufpool.touch(d)
            try:
                # host destinations are read into in place, card ones
                # through pinned staging (one vectored read either way)
                ok = not total or _recvmsg_into_views(
                    conn, [_recvpool.host_view(h) for h in hosts])
                _recvpool.finish_steer(staged, ok)
            except BaseException:
                if tag >= 0:
                    reg.steer_abort(out)
                raise
            if tag >= 0:
                if ok:
                    reg.steer_done(out)
                else:
                    # torn mid-steer: the destination never reaches the
                    # mailbox; the owner's fallback refill overwrites it
                    reg.steer_abort(out)
            if ok:
                _mpit.count(recv_pool_rendezvous=1, recv_bytes_steered=total)
                rec = _telemetry.REC
                if rec is not None:
                    rec.emit("recvpool", "steer",
                             attrs={"src": src, "seq": seq, "tag": tag,
                                    "nbytes": total})
            return ok, (ctx, tag, out, stamp)
        host = codec.alloc_raw(plan, self.device)
        ok = _recvmsg_into_views(conn, [_bufpool.byte_view(h) for h in host])
        if not ok:
            for h in host:
                _recvpool.RECV_POOL.give_back(h)
            return False, None
        return True, (ctx, tag, codec.finish_raw(plan, host, self.device),
                      stamp)

    def _deliver_seq(self, conn: socket.socket, src: int, seq: int, gen: int,
                     ctx, tag: int, obj: Any, stamp: Any = None) -> None:
        """Sequenced delivery: contiguous frames reach the mailbox, replay
        duplicates and a purged incarnation's frames are dropped, a gap is
        a loud protocol error (the channel is killed first so the sender
        sees a dead link)."""
        try:
            delivered = self._link.rx_gate(
                src, seq,
                lambda: self.mailbox.deliver(src, ctx, tag, obj, stamp), gen)
        except TransportError:
            conn.close()
            raise
        rec = _telemetry.REC
        if rec is not None and delivered:
            rec.emit("frame", "recv",
                     attrs={"src": src, "seq": seq, "tag": tag})

    # -- cumulative-ack flusher --------------------------------------------

    def _ack_flush_loop(self) -> None:
        link = self._link
        # per-peer dial cool-down: an unreachable peer must not starve the
        # standalone acks to every other source
        next_try: Dict[int, float] = {}
        fails: Dict[int, int] = {}
        while not self._closing:
            try:
                srcs = link.wait_ack_pending(_ACK_IDLE_S)
            except Exception:  # pragma: no cover - teardown race
                return
            if self._closing:
                return
            # idle-link keepalive: every wakeup, acks pending or not
            self._keepalive_probe(next_try, fails)
            if not srcs:
                continue
            time.sleep(_ACK_BATCH_S)  # coalesce a delivery burst
            for src in srcs:
                if self._closing:
                    return
                value = link.peek_ack(src)
                if value is None:
                    continue  # a piggyback beat us to it
                if self._suspect(src):
                    # dead peer: nobody waits on these acks, and redialing
                    # its corpse every round would spin
                    link.note_ack_sent(src, value)
                    continue
                if time.monotonic() < next_try.get(src, 0.0):
                    continue
                try:
                    with self._send_lock(src):
                        with self._conn_lock:
                            conn = self._conns.get(src)
                        if conn is None:
                            conn = self._establish_locked(
                                src, time.monotonic() + 2.0,
                                backoff_delays())
                        conn.sendall(_HEADER.pack(_ACK_FLAG, 0, value))
                    link.note_ack_sent(src, value)
                    self._dial_ok(src, fails, next_try)
                except (OSError, TransportError, EpochSkewError):
                    # best-effort: drop a broken conn so a later round
                    # re-dials; diagnosis belongs to the data path and
                    # the membership layer
                    self._drop_conn(src)
                    self._dial_backoff(src, fails, next_try)

    @staticmethod
    def _dial_ok(dest: int, fails: Dict[int, int],
                 next_try: Dict[int, float]) -> None:
        fails.pop(dest, None)
        next_try.pop(dest, None)

    @staticmethod
    def _dial_backoff(dest: int, fails: Dict[int, int],
                      next_try: Dict[int, float]) -> None:
        """Per-peer dial cool-down: consecutive failures back the peer off
        exponentially (5 s cap)."""
        fails[dest] = fails.get(dest, 0) + 1
        next_try[dest] = time.monotonic() + min(
            5.0, 0.25 * (2.0 ** fails[dest]))

    def _keepalive_probe(self, next_try: Dict[int, float],
                         fails: Dict[int, int]) -> None:
        """Idle-link keepalive (cvar ``link_keepalive_s``): probe every
        CACHED connection that sent nothing for the keepalive period with
        a header-only ack frame.  A link torn while idle fails the probe
        and heals HERE (reconnect + resume-replay on a short fuse), so the
        next real send finds a live link.  A probe never waits behind an
        in-flight send (a busy link is not idle)."""
        ka = _resilience._KEEPALIVE_S
        if ka <= 0:
            return
        now = time.monotonic()
        with self._conn_lock:
            idle = [d for d in self._conns
                    if now - self._last_send.get(d, 0.0) >= ka]
        for dest in idle:
            if self._closing:
                return
            if self._suspect(dest) or now < next_try.get(dest, 0.0):
                continue
            lock = self._send_lock(dest)
            if not lock.acquire(blocking=False):
                continue  # a send is mid-frame: the link is not idle
            try:
                with self._conn_lock:
                    conn = self._conns.get(dest)
                if conn is None:
                    continue
                try:
                    conn.sendall(_HEADER.pack(
                        _ACK_FLAG, 0, self._link.piggyback_ack(dest)))
                    self._last_send[dest] = time.monotonic()
                    self._dial_ok(dest, fails, next_try)
                except OSError:
                    self._drop_conn(dest)
                    try:
                        self._establish_locked(
                            dest, time.monotonic() + 2.0, backoff_delays())
                        _mpit.count(link_faults_masked=1)
                        self._dial_ok(dest, fails, next_try)
                    except (OSError, TransportError, EpochSkewError):
                        self._dial_backoff(dest, fails, next_try)
            finally:
                lock.release()

    # -- outgoing ----------------------------------------------------------

    def _send_lock(self, dest: int) -> threading.Lock:
        # _conn_lock guards only the dict; the (possibly slow) rendezvous
        # poll and connect happen under the per-dest lock
        with self._conn_lock:
            lock = self._send_locks.get(dest)
            if lock is None:
                lock = self._send_locks[dest] = threading.Lock()
            return lock

    def _drop_conn(self, dest: int) -> None:
        """Forget and close the cached connection to ``dest``; the
        retained window and seq state survive — that is the point."""
        with self._conn_lock:
            conn = self._conns.pop(dest, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _suspect(self, dest: int) -> bool:
        """PEER-fault verdict for link classification: the detector's
        failed set, or a heartbeat stale past the bound
        (``ft.WorldFT.link_suspect``).  Without fault tolerance there is no
        authority on peer death: every fault is a link fault."""
        world = getattr(self, "_ft_world", None)
        return world is not None and world.link_suspect(dest)

    def _abort_if_closing(self, dest: int) -> None:
        """The connect loops' abort: the transport is closing, or the
        peer was declared failed mid-dial (a peer fault, raised now, not
        after the connection deadline)."""
        if self._closing:
            raise _LinkAbort(f"rank {self.world_rank}: transport closed "
                             f"while connecting to rank {dest}")
        if self._suspect(dest):
            raise _LinkAbort(f"rank {self.world_rank}: peer {dest} declared "
                             f"failed while connecting to it")

    def _get_conn_locked(self, dest: int) -> socket.socket:
        """The connection to ``dest``; caller holds the per-dest lock.
        First connection of a world: bounded by ``connect_timeout``."""
        with self._conn_lock:
            conn = self._conns.get(dest)
        if conn is not None:
            return conn
        deadline = time.monotonic() + self._connect_timeout
        while _membership.read_port(self._rdv, dest) is None:
            if time.monotonic() > deadline:
                raise TransportError(
                    f"rank {self.world_rank}: peer {dest} did not publish a "
                    f"port within {self._connect_timeout}s (rendezvous dir "
                    f"{self._rdv})")
            time.sleep(0.005)
        return self._establish_locked(dest, deadline,
                                      iter(lambda: 0.01, None),
                                      abort=lambda: self._abort_if_closing(dest))

    def _establish_locked(self, dest: int, deadline: float, delays,
                          abort=None) -> socket.socket:
        """Dial + handshake + resume-replay loop; caller holds the per-dest
        send lock.  hello(rank, epoch) -> ack(peer epoch, last delivered):

        * a peer epoch NEWER than ours past the grace: WE are the stale
          straggler (shrunk out) — EpochSkewError;
        * a peer epoch below ``min_peer_epoch[dest]``: a stale incarnation
          still on the old endpoint of a replaced slot — retry against a
          re-read port file until the replacement publishes;
        * otherwise prune the retained window to the peer's mark, REPLAY
          the frames beyond it and register the connection."""
        skew_since = None
        while True:
            if abort is not None:
                abort()
            port = _membership.read_port(self._rdv, dest)
            conn = None
            if port is not None:
                try:
                    conn = socket.create_connection((_HOST, port),
                                                    timeout=5.0)
                    if conn.getsockname() == conn.getpeername():
                        # Linux loopback SELF-CONNECT (TCP simultaneous
                        # open onto a port nobody listens on): a failed dial
                        conn.close()
                        conn = None
                except OSError:
                    conn = None
            if conn is not None:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(10.0)
                try:
                    conn.sendall(_HELLO.pack(self.world_rank, self.epoch))
                    ack = _recv_exact(conn, _HELLO_ACK.size)
                except OSError:
                    ack = None
                if ack is not None:
                    peer_epoch, resume_seq = _HELLO_ACK.unpack(ack)
                    if peer_epoch > self.epoch:
                        conn.close()
                        # our own bump may lag a broadcast transition by a
                        # moment (self.epoch is re-read each retry)
                        if skew_since is None:
                            skew_since = time.monotonic()
                        if time.monotonic() - skew_since > _EPOCH_GRACE_S:
                            _mpit.count(epoch_skews=1)
                            raise EpochSkewError(
                                f"rank {self.world_rank}: peer {dest} is at "
                                f"membership epoch {peer_epoch}, this process "
                                f"at {self.epoch} — this process was shrunk "
                                f"out of the world (stale-epoch straggler)",
                                local_epoch=self.epoch, peer_epoch=peer_epoch,
                                peer=dest)
                        time.sleep(0.01)
                        continue
                    skew_since = None
                    if peer_epoch >= self.min_peer_epoch.get(dest, 0):
                        if self._replay_locked(dest, conn, resume_seq):
                            conn.settimeout(None)
                            with self._conn_lock:
                                self._conns[dest] = conn
                            # a fresh connection needs no probe for a
                            # keepalive period
                            self._last_send[dest] = time.monotonic()
                            if self._link.mark_connected(dest):
                                _mpit.count(link_reconnects=1)
                                rec = _telemetry.REC
                                if rec is not None:
                                    rec.emit("link", "reconnect",
                                             attrs={"peer": dest})
                            return conn
                        conn = None  # replay tripped: a miss
                if conn is not None:
                    conn.close()  # stale incarnation, or a torn handshake
            if time.monotonic() > deadline:
                raise TransportError(
                    f"rank {self.world_rank}: cannot connect to rank "
                    f"{dest} at epoch >= {self.min_peer_epoch.get(dest, 0)} "
                    f"within the connection deadline")
            time.sleep(next(delays))

    def _replay_locked(self, dest: int, conn: socket.socket,
                       resume_seq: int) -> bool:
        """Resume round of a fresh handshake: prune the retained window to
        the peer's delivery mark and replay every frame beyond it in seq
        order.  False on a mid-replay socket error (the caller redials)."""
        pending = self._link.resume(dest, resume_seq)
        rec = _telemetry.REC
        if rec is not None and pending:
            rec.emit("link", "replay",
                     attrs={"peer": dest, "frames": len(pending),
                            "resume_seq": resume_seq})
        for seq, word, body in pending:
            views = body.pin()
            if views is None:
                continue  # released mid-replay: acked, the peer has it
            try:
                _sendmsg_views(conn, [
                    _HEADER.pack(word, seq, self._link.piggyback_ack(dest)),
                    *views])
            except OSError:
                try:
                    conn.close()
                except OSError:
                    pass
                return False
            finally:
                body.unpin()
            _mpit.count(link_frames_replayed=1)
        return True

    def _heal_link_locked(self, dest: int, err: OSError) -> None:
        """A send-path OSError is a link fault: reconnect with exponential
        backoff + jitter bounded by the retry budget.  On success the
        retained-window replay already resent the failed frame.  Caller
        holds the per-dest send lock."""
        self._drop_conn(dest)
        retry_s = _resilience._RETRY_TIMEOUT_S
        if self._suspect(dest):
            raise TransportError(
                f"rank {self.world_rank}: send to rank {dest} failed ({err}); "
                f"the peer is failure-suspected — not retrying a dead peer's "
                f"link") from err
        rec = _telemetry.REC
        t_heal = time.perf_counter_ns()
        try:
            self._establish_locked(dest, time.monotonic() + retry_s,
                                   backoff_delays(),
                                   abort=lambda: self._abort_if_closing(dest))
        except EpochSkewError:
            raise  # the membership diagnosis outranks link healing
        except (OSError, TransportError) as e:
            if rec is not None:
                rec.emit("link", "heal",
                         dur_ns=time.perf_counter_ns() - t_heal,
                         attrs={"peer": dest, "ok": False,
                                "error": "retry_timeout"})
            raise TransportError(
                f"rank {self.world_rank}: link to rank {dest} not "
                f"re-established within {retry_s}s (original fault: "
                f"{err}; {e})") from err
        heal_s = (time.perf_counter_ns() - t_heal) / 1e9
        # always recorded: a heal is already a multi-ms reconnect
        _mpit.hist_record("link_heal_s", heal_s)
        if rec is not None:
            rec.emit("link", "heal", dur_ns=int(heal_s * 1e9),
                     attrs={"peer": dest, "ok": True})
        _mpit.count(link_faults_masked=1)

    def send(self, dest: int, ctx, tag: int, payload: Any) -> None:
        if not (0 <= dest < self.world_size):
            raise ValueError(f"dest {dest} out of range for world size {self.world_size}")
        if dest == self.world_rank:
            # value-semantics copy, counted on its steering channel first
            # (loopback traffic consumes posted slots like any arrival)
            reg = self.recv_registry
            if tag < 0 or (reg.user_count
                           and reg.user_active(dest, ctx, tag)):
                reg.note_local(dest, ctx, tag)
            vc = self.verify_clock
            stamp = vc.tick_send() if vc is not None else None
            self.mailbox.deliver(dest, ctx, tag, codec.value_copy(payload),
                                 stamp)
            return
        vc = self.verify_clock
        if vc is not None:
            # the stamp rides in the frame's pickled ctx slot (the raw
            # meta or the pickle body), never in the tensor bytes; the
            # reader unwraps right after parse, so a replay delivers it
            # once through the rx_gate dedup
            ctx = vc.wrap(ctx)
        frame = codec.pack_raw_frame(ctx, tag, payload)
        if frame is not None:
            head, bufs = frame
            self._send_parts(dest, codec.RAW_FLAG, [head, *bufs])
            return
        self._send_parts(dest, 0, [codec.pack_pickle_body(ctx, tag, payload)])

    def _send_parts(self, dest: int, flags: int, parts) -> None:
        """Sequenced frame send: wait for window room, retain the body BY
        REFERENCE (a ``bufpool.BufRef``), stream it with one vectored
        ``sendmsg``, heal on OSError."""
        link = self._link
        body = _bufpool.BufRef(parts)
        if body.ranges:
            # reuse-on-send: a region already retained unacked is about
            # to ship again — the OLDER frames snapshot
            _bufpool.touch_ranges(body.ranges, exclude=body)
        nbytes = body.nbytes
        word = flags | nbytes
        try:
            # outside the send lock: a window-full wait must not hold the
            # lock the ack flusher needs for this dest
            link.wait_window(dest, nbytes, self._suspect,
                             lambda: self._closing)
            lock = self._send_lock(dest)
            lock.acquire()
            try:
                conn = self._get_conn_locked(dest)
                seq = link.tx_retain(dest, word, body)
            except BaseException:
                lock.release()
                raise
        except BaseException:
            # until tx_retain hands the ref to the window, every raise
            # must release it, or the live-range index leaks it
            body.release()
            raise
        try:
            header = _HEADER.pack(word, seq, link.piggyback_ack(dest))
            pinned = body.pin()
            if pinned is None:
                return  # ref released: window torn down (closing)
            hook = self._link_fault_hook
            rec = _telemetry.REC
            # stamped at send START: tracecat's matching needs send <= recv
            t_send = time.perf_counter_ns() if rec is not None else 0
            try:
                if hook is None:
                    _sendmsg_views(conn, [header, *pinned])
                else:
                    # link-fault injection: the header/body split is the
                    # point ('mid' = a reset between header and body)
                    hook(dest, "pre")
                    conn.sendall(header)
                    _mpit.count(link_send_syscalls=1)
                    hook(dest, "mid")
                    _sendmsg_views(conn, pinned)
                self._last_send[dest] = time.monotonic()
                if rec is not None:
                    rec.emit("frame", "send",
                             dur_ns=time.perf_counter_ns() - t_send,
                             attrs={"dest": dest, "seq": seq,
                                    "nbytes": nbytes})
            except OSError as e:
                self._heal_link_locked(dest, e)
            finally:
                body.unpin()
        finally:
            lock.release()

    # -- link-fault injection (transport/faulty.py) ---------------------------

    def install_link_faults(self, injector) -> None:
        """Attach a connection-level fault injector (``FaultyTransport``
        link kwargs): its hook fires in this send path whatever handle
        triggered the send, and its accept-drop budget is consumed by the
        acceptor."""
        self._link_fault_hook = injector._link_hook
        self._accept_drop_n += int(getattr(injector, "link_accept_drop", 0))

    def _inject_link_reset(self, dest: int) -> None:
        """Tear down the cached connection to ``dest`` NOW (RST: SO_LINGER
        0), so the in-flight send fails and the healing path takes over;
        the retained window is untouched."""
        with self._conn_lock:
            conn = self._conns.pop(dest, None)
        if conn is not None:
            try:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            rec = _telemetry.REC
            if rec is not None:
                # the timeline's cause marker: the reset, then the heal,
                # reconnect and replay events that answer it
                rec.emit("link", "reset_injected", attrs={"peer": dest})

    # -- membership (membership.py) --------------------------------------------

    def membership_invalidate(self, dead) -> None:
        """Drop cached connections to replaced slots so the next send
        re-handshakes (port-file re-read, epoch-checked hello), under each
        per-dest send lock (a frame streaming on the old connection
        finishes or fails first).  The slot's resilience state goes too
        (``purge_peer``), the steering registry resyncs to the bumped
        generation, and the slot's INBOUND readers are closed: a
        replacement whose hello raced the transition reconnects and
        replays onto a reader of the fresh generation."""
        for dest in dead:
            with self._send_lock(dest):
                with self._conn_lock:
                    conn = self._conns.pop(dest, None)
                if conn is not None:
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        conn.close()
                    except OSError:
                        pass
                self._link.purge_peer(dest)
                self.recv_registry.purge_src(dest, self._link.peer_gen(dest))
            with self._conn_lock:
                readers = self._reader_conns.pop(dest, [])
            for rc in readers:
                try:
                    rc.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    rc.close()
                except OSError:
                    pass

    # -- shutdown ----------------------------------------------------------

    def close(self) -> None:
        """Close every connection and join the transport's threads."""
        if self._closing:
            return
        self._closing = True
        try:
            self._listener.shutdown(socket.SHUT_RDWR)  # wakes accept()
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._link.close()  # frees window waiters + parks the flusher out
        with self._conn_lock:
            conns = list(self._conns.values()) + [c for c, _ in self._readers]
            readers = [t for _, t in self._readers]
            self._conns.clear()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self.mailbox.close()
        for t in readers + [self._ack_thread, self._accept_thread]:
            if t is not threading.current_thread():
                t.join(timeout=2.0)
