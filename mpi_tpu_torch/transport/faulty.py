"""Fault-injection transport wrapper — the port's own copy of
``mpi_tpu/transport/faulty.py``: ``KilledRankError`` (:71) and
``FaultyTransport`` (:80) with ``_link_hook`` (:134).

Wraps any Transport and injects faults on the send path:

* ``drop_every`` — silently drop every k-th message (a lossy link);
* ``delay_s`` — sleep before delivering (congestion);
* ``duplicate_every`` — deliver every k-th message twice (retry storms);
* ``kill_after_n`` — the n-th send KILLS this rank (crash-stop: the send
  and everything after it vanish, :class:`KilledRankError` is raised so
  the rank's program stops, and the detector sees ``killed`` and stops
  beating — the in-process counterpart of ``os._exit``);
* ``crash_on_send_to`` — like ``kill_after_n``, triggered by the first
  send addressed to one world rank (dies before delivering).

Connection-level link faults exercise the socket transport's resilient
link (``resilience.py``); they are INSTALLED into the wrapped transport
(``SocketTransport.install_link_faults``) and fire in its send path:

* ``link_reset_every`` — every k-th frame, reset the connection before
  any byte of the frame is written;
* ``link_reset_midframe_every`` — every k-th frame, reset it between the
  header and the body;
* ``link_stall_every`` / ``link_stall_s`` — stall the link (a slow link
  is not a fault: nothing may reconnect, suspect or error);
* ``link_accept_drop`` — the acceptor drops this many incoming
  connections after reading the hello.

Transports without a connection (local threads) reject the link kwargs
with ``ValueError``.  The ``dropped`` / ``duplicated`` tallies are also
the pvars ``faulty_dropped`` / ``faulty_duplicated``.

A killed local rank may leave its last clones queued on the card; they
sit in mailboxes under the communicator contexts the rank was using, and
the survivors' ``shrink`` moves to a fresh context, so no later
collective matches them.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from .. import mpit as _mpit
from .base import Transport


class KilledRankError(RuntimeError):
    """Raised on the injected-death rank itself (and on any later use of
    its transport).  ``run_local`` treats it as a simulated crash: the
    rank's result slot records ``KILLED`` and the survivors' mailboxes
    stay open, so the failure is theirs to detect."""


class FaultyTransport(Transport):
    def __init__(self, inner: Transport, drop_every: int = 0,
                 delay_s: float = 0.0, duplicate_every: int = 0,
                 kill_after_n: int = 0,
                 crash_on_send_to: Optional[int] = None,
                 link_reset_every: int = 0,
                 link_reset_midframe_every: int = 0,
                 link_stall_every: int = 0, link_stall_s: float = 0.0,
                 link_accept_drop: int = 0) -> None:
        self.inner = inner
        self.world_rank = inner.world_rank
        self.world_size = inner.world_size
        self.mailbox = inner.mailbox
        self.device = inner.device
        self.aliases_payloads = inner.aliases_payloads
        # decorate, don't re-tune: collectives through the injector
        # segment exactly like the wrapped data plane
        self.coll_segment_hint = inner.coll_segment_hint
        self.drop_every = drop_every
        self.delay_s = delay_s
        self.duplicate_every = duplicate_every
        self.kill_after_n = kill_after_n
        self.crash_on_send_to = crash_on_send_to
        self._n = 0
        self._lock = threading.Lock()
        self.dropped = 0
        self.duplicated = 0
        self.killed = False  # read by the ft.py detector (stops beating)
        self.link_reset_every = link_reset_every
        self.link_reset_midframe_every = link_reset_midframe_every
        self.link_stall_every = link_stall_every
        self.link_stall_s = link_stall_s
        self.link_accept_drop = link_accept_drop
        self._link_n = 0
        self.link_resets = 0
        self.link_midframe_resets = 0
        self.link_stalls = 0
        if (link_reset_every or link_reset_midframe_every
                or link_stall_every or link_accept_drop):
            install = getattr(inner, "install_link_faults", None)
            if install is None:
                raise ValueError(
                    f"link-fault injection needs a transport with "
                    f"connection-level links (socket); "
                    f"{type(inner).__name__} has none")
            install(self)

    # the membership epoch is the wrapped transport's
    @property
    def epoch(self) -> int:
        return self.inner.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self.inner.epoch = value

    @property
    def min_peer_epoch(self):
        return self.inner.min_peer_epoch

    @classmethod
    def wrapper(cls, **kwargs):
        """For ``run_local``'s ``transport_wrapper`` hook."""
        return lambda inner: cls(inner, **kwargs)

    def _link_hook(self, dest: int, stage: str) -> None:
        """Fired by the inner transport's send path: ``pre`` before any
        byte of a frame, ``mid`` between header and body.  Frames are
        counted once (at ``pre``)."""
        if stage == "pre":
            with self._lock:
                self._link_n += 1
                n = self._link_n
            if (self.link_stall_every and self.link_stall_s
                    and n % self.link_stall_every == 0):
                self.link_stalls += 1
                time.sleep(self.link_stall_s)
            if self.link_reset_every and n % self.link_reset_every == 0:
                self.link_resets += 1
                self.inner._inject_link_reset(dest)
        elif stage == "mid":
            with self._lock:
                n = self._link_n
            if (self.link_reset_midframe_every
                    and n % self.link_reset_midframe_every == 0):
                self.link_midframe_resets += 1
                self.inner._inject_link_reset(dest)

    def _die(self, why: str) -> None:
        self.killed = True
        raise KilledRankError(
            f"rank {self.world_rank}: injected death ({why})")

    def send(self, dest: int, ctx, tag: int, payload: Any) -> None:
        if self.killed:
            self._die("already dead")
        if self.crash_on_send_to is not None and dest == self.crash_on_send_to:
            self._die(f"crash_on_send_to={dest}")
        with self._lock:
            self._n += 1
            n = self._n
        if self.kill_after_n and n >= self.kill_after_n:
            self._die(f"kill_after_n={self.kill_after_n}")
        if self.drop_every and n % self.drop_every == 0:
            self.dropped += 1
            _mpit.count(faulty_dropped=1)
            return
        if self.delay_s:
            time.sleep(self.delay_s)
        self.inner.send(dest, ctx, tag, payload)
        if self.duplicate_every and n % self.duplicate_every == 0:
            self.duplicated += 1
            _mpit.count(faulty_duplicated=1)
            self.inner.send(dest, ctx, tag, payload)

    def recv(self, source: int, ctx, tag: int, timeout: Optional[float] = None):
        if self.killed:
            self._die("already dead")
        return self.inner.recv(source, ctx, tag, timeout)

    def close(self) -> None:
        self.inner.close()
