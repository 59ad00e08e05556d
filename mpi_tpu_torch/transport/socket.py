"""TCP socket transport — the port's own copy of
``mpi_tpu/transport/socket.py``, with ``coll_segment_hint = 4 << 20``
(:237) as it is.

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
from ..resilience import LinkState, backoff_delays
from . import codec
from .base import Transport, TransportError

# Connection handshake: the connector sends its world rank, the acceptor
# answers with the last sequence number it contiguously delivered from
# this connector (a fresh world answers 0; a reconnect prunes the
# retained window to that mark and replays the rest).
_HELLO = struct.Struct("!i")        # rank
_HELLO_ACK = struct.Struct("!Q")    # resume(last delivered)
_HEADER = struct.Struct("!QQQ")     # flags|payload_len, seq, cumulative ack
# Header word bit 62: a standalone cumulative-ack control frame (no body,
# seq 0, outside the sequenced stream).  codec.RAW_FLAG is bit 63, so body
# lengths live in the low 62 bits.
_ACK_FLAG = 1 << 62
_LEN_MASK = _ACK_FLAG - 1
_HOST = "127.0.0.1"

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

    def __init__(self, rank: int, size: int, rdv_dir: str, device=None,
                 connect_timeout: float = 60.0) -> None:
        super().__init__(rank, size, device)
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
        self._link = LinkState(size)
        self.recv_registry = _recvpool.PostedRecvRegistry()

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
            (src,) = _HELLO.unpack(hello)
            conn.sendall(_HELLO_ACK.pack(self._link.delivered(src)))
        except OSError:  # the connector vanished, or close() got here first
            conn.close()
            return
        self._reader_loop(conn, src)

    def _reader_loop(self, conn: socket.socket, src: int) -> None:
        while True:
            head, torn = _recv_exact2(conn, _HEADER.size)
            if head is None:
                # link fault or clean close: keep the rx stream state —
                # the sender reconnects and replays unacked frames
                if torn:
                    _mpit.count(link_torn_frames=1)
                conn.close()
                return
            word, seq, ack = _HEADER.unpack(head)
            if ack:
                self._link.tx_ack(src, ack)
            if word & _ACK_FLAG:
                continue  # header-only control frame
            plen = word & _LEN_MASK
            if word & codec.RAW_FLAG:
                ok, obj_ctx_tag = self._read_raw(conn, src, seq, plen)
                if not ok:
                    _mpit.count(link_torn_frames=1)
                    conn.close()
                    return
                ctx, tag, out = obj_ctx_tag
                self._deliver_seq(conn, src, seq, ctx, tag, out)
                continue
            payload, _ = _recv_exact2(conn, plen)
            if payload is None:
                _mpit.count(link_torn_frames=1)  # past the header: torn
                conn.close()
                return
            ctx, tag, obj = pickle.loads(payload)
            if tag < 0 and self._link.rx_fresh(src, seq):
                # pickle frames on counted channels still count (never
                # steerable) so the frame/consumer pairing stays aligned
                self.recv_registry.note_frame(src, ctx, tag, seq, 0, None)
            self._deliver_seq(conn, src, seq, ctx, tag, obj)

    def _read_raw(self, conn: socket.socket, src: int, seq: int, plen: int):
        """Read one raw frame's meta and body: ``(ok, (ctx, tag, payload))``,
        ok False on a torn frame."""
        mhead, _ = _recv_exact2(conn, codec.META.size)
        if mhead is None:
            return False, None
        (mlen,) = codec.META.unpack(mhead)
        meta, _ = _recv_exact2(conn, mlen)
        if meta is None:
            return False, None
        ctx, tag, plan = codec.parse_raw_meta(meta)
        total = codec.plan_nbytes(plan)
        if codec.META.size + mlen + total != plen:
            # a meta that disagrees with the length word would desync the
            # byte stream: kill the channel and fail loudly
            conn.close()
            raise ValueError(
                f"raw frame length mismatch from rank {src}: header says "
                f"{plen}, meta implies {codec.META.size + mlen + total}")
        # Rendezvous steering: count a FRESH internal-tag frame on its
        # channel; a paired posted destination takes the body directly.
        out = None
        if tag < 0 and self._link.rx_fresh(src, seq):
            out = self.recv_registry.note_frame(src, ctx, tag, seq, 0, plan)
        if out is not None:
            # copy-on-write any retained frame still referencing the
            # destination region BEFORE writing it
            _bufpool.touch(out)
            if out.device.type == "cpu":
                ok = not total or _recvmsg_into_views(
                    conn, [_bufpool.byte_view(out)])
            else:
                host = _recvpool.RECV_POOL.empty(out.shape, out.dtype)
                ok = not total or _recvmsg_into_views(
                    conn, [_bufpool.byte_view(host)])
                if ok:
                    out.copy_(host)
                _recvpool.RECV_POOL.give_back(host)
            if ok:
                _mpit.count(recv_pool_rendezvous=1, recv_bytes_steered=total)
            return ok, (ctx, tag, out)
        host = codec.alloc_raw(plan, self.device)
        ok = _recvmsg_into_views(conn, [_bufpool.byte_view(h) for h in host])
        if not ok:
            for h in host:
                _recvpool.RECV_POOL.give_back(h)
            return False, None
        return True, (ctx, tag, codec.finish_raw(plan, host, self.device))

    def _deliver_seq(self, conn: socket.socket, src: int, seq: int,
                     ctx, tag: int, obj: Any) -> None:
        """Sequenced delivery: contiguous frames reach the mailbox, replay
        duplicates are dropped, a gap is a loud protocol error (the
        channel is killed first so the sender sees a dead link)."""
        try:
            self._link.rx_gate(
                src, seq, lambda: self.mailbox.deliver(src, ctx, tag, obj))
        except TransportError:
            conn.close()
            raise

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
            if not srcs:
                continue
            time.sleep(_ACK_BATCH_S)  # coalesce a delivery burst
            for src in srcs:
                if self._closing:
                    return
                value = link.peek_ack(src)
                if value is None:
                    continue  # a piggyback beat us to it
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
                    fails.pop(src, None)
                    next_try.pop(src, None)
                except (OSError, TransportError):
                    # best-effort: drop a broken conn so a later round
                    # re-dials; diagnosis belongs to the data path
                    self._drop_conn(src)
                    fails[src] = fails.get(src, 0) + 1
                    next_try[src] = time.monotonic() + min(
                        5.0, 0.25 * (2.0 ** fails[src]))

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

    def _abort_if_closing(self) -> None:
        if self._closing:
            raise _LinkAbort(f"rank {self.world_rank}: transport closed "
                             f"while connecting")

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
                                      abort=self._abort_if_closing)

    def _establish_locked(self, dest: int, deadline: float, delays,
                          abort=None) -> socket.socket:
        """Dial + handshake + resume-replay loop; caller holds the per-dest
        send lock.  The acceptor's answer is the last seq it delivered
        from us: prune the retained window to it and REPLAY the frames
        beyond it, then register the connection."""
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
                    conn.sendall(_HELLO.pack(self.world_rank))
                    ack = _recv_exact(conn, _HELLO_ACK.size)
                except OSError:
                    ack = None
                if ack is not None:
                    (resume_seq,) = _HELLO_ACK.unpack(ack)
                    if self._replay_locked(dest, conn, resume_seq):
                        conn.settimeout(None)
                        with self._conn_lock:
                            self._conns[dest] = conn
                        if self._link.mark_connected(dest):
                            _mpit.count(link_reconnects=1)
                        return conn
                else:
                    conn.close()
            if time.monotonic() > deadline:
                raise TransportError(
                    f"rank {self.world_rank}: cannot connect to rank "
                    f"{dest} within the connection deadline")
            time.sleep(next(delays))

    def _replay_locked(self, dest: int, conn: socket.socket,
                       resume_seq: int) -> bool:
        """Resume round of a fresh handshake: prune the retained window to
        the peer's delivery mark and replay every frame beyond it in seq
        order.  False on a mid-replay socket error (the caller redials)."""
        for seq, word, body in self._link.resume(dest, resume_seq):
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
        try:
            self._establish_locked(dest, time.monotonic() + retry_s,
                                   backoff_delays(),
                                   abort=self._abort_if_closing)
        except (OSError, TransportError) as e:
            raise TransportError(
                f"rank {self.world_rank}: link to rank {dest} not "
                f"re-established within {retry_s}s (original fault: "
                f"{err}; {e})") from err
        _mpit.count(link_faults_masked=1)

    def send(self, dest: int, ctx, tag: int, payload: Any) -> None:
        if not (0 <= dest < self.world_size):
            raise ValueError(f"dest {dest} out of range for world size {self.world_size}")
        if dest == self.world_rank:
            # value-semantics copy, counted on its steering channel first
            # (loopback traffic consumes posted slots like any arrival)
            if tag < 0:
                self.recv_registry.note_local(dest, ctx, tag)
            self.mailbox.deliver(dest, ctx, tag, codec.value_copy(payload))
            return
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
            link.wait_window(dest, nbytes, lambda: self._closing)
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
            try:
                _sendmsg_views(conn, [header, *pinned])
            except OSError as e:
                self._heal_link_locked(dest, e)
            finally:
                body.unpin()
        finally:
            lock.release()

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
