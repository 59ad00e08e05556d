"""Runtime wildcard-race detection via piggybacked vector clocks — the
port's own copy of ``mpi_tpu/verify/vclock.py`` (``VClock`` :49,
``_concurrent`` :42).

On the socket transport the stamp rides in the frame's pickled header (the
wrapped ctx); a tensor payload still travels as raw bytes, so
``bytes_pickled_sent`` does not move under verify.

The static rule MPL009 can only say "maybe": an ``ANY_SOURCE`` receive
with two eligible senders *might* match either.  Verify mode closes the
loop dynamically.  Every rank carries a vector clock; under verify each
send ticks the sender's component and ships the stamp with the message
(wrapped around the wire ctx by the transports, or passed straight to
the mailbox on same-process paths).  When a receive consumes a message
the receiver merges the stamp (componentwise max, then ticks itself),
so the clocks encode the happens-before order of the run.

The race check rides the one place that can see every alternative: the
mailbox consume scan.  When a *wildcard* receive (user tag) consumes a
message, any other pending message from a different sender that the same
receive could have matched is compared against the winner — if the two
send stamps are **concurrent** (neither ≤ the other componentwise, i.e.
no chain of messages ordered one send before the other), the match order
was decided by arrival timing alone and is reported as a named
nondeterminism race: the ``verify_wildcard_races`` pvar, a finalize
report line naming both candidate senders, and a trace event.

Off verify mode nothing here runs: transports hold ``verify_clock is
None`` and the mailbox holds ``clock is None`` — one ``is None`` test
per operation, and both pvars stay exactly 0.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

from .. import mpit as _mpit
from .. import telemetry as _telemetry
from .state import report_add, user_site

# Wire marker for a stamped ctx: ("__mpi_tpu_vclock__", stamp, real_ctx),
# the reference's spelling.
# Only remote paths wrap (the stamp must survive pickling/framing);
# same-process deliveries hand the stamp to the mailbox directly.
_VC_MARK = "__mpi_tpu_vclock__"


def _concurrent(a: Sequence[int], b: Sequence[int]) -> bool:
    """Neither stamp happens-before the other."""
    a_le_b = all(x <= y for x, y in zip(a, b))
    b_le_a = all(y <= x for x, y in zip(a, b))
    return not a_le_b and not b_le_a


class VClock:
    """One rank's vector clock plus the race bookkeeping.

    Attached by :func:`mpi_tpu_torch.verify.enable` as ``transport.verify_clock``
    (send-side stamping) and ``mailbox.clock`` (consume-side merge +
    race check).  All methods are self-contained so the transports need
    no verify imports — they only ever test ``verify_clock is None``.
    """

    def __init__(self, rank: int, size: int) -> None:
        self.rank = int(rank)
        self.size = int(size)
        self._vec: List[int] = [0] * self.size
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._seen = set()  # (lo_src, hi_src, tag) already reported
        self.races = 0      # this world's count (pvar aggregates globally)

    # -- send side ---------------------------------------------------------

    def tick_send(self) -> Tuple[int, ...]:
        """Advance our component and return the stamp to ship (8 bytes
        per component, priced by the verify_clock_bytes pvar)."""
        with self._lock:
            self._vec[self.rank] += 1
            stamp = tuple(self._vec)
        _mpit.count(verify_clock_bytes=8 * self.size)
        return stamp

    def wrap(self, ctx):
        """Stamp a wire-bound ctx (socket/shm framing paths)."""
        return (_VC_MARK, self.tick_send(), ctx)

    @staticmethod
    def unwrap(ctx):
        """(real_ctx, stamp-or-None) — reader side, right after parse,
        BEFORE steering consults keyed on the real ctx."""
        if isinstance(ctx, tuple) and len(ctx) == 3 and ctx[0] == _VC_MARK:
            return ctx[2], ctx[1]
        return ctx, None

    # -- receive-site attribution ------------------------------------------

    def set_site(self, site: Optional[str]) -> None:
        """Record the user call site of the wildcard receive the current
        thread is about to consume for (race message attribution)."""
        self._tls.site = site

    # -- consume side ------------------------------------------------------

    def note_consume(self, src: int, tag: int, stamp,
                     alternates: Sequence[Tuple[int, object]],
                     wildcard: bool) -> None:
        """Merge a consumed message's stamp into this rank's clock; when
        the consume was a wildcard match, compare the winner against
        every other pending eligible sender and report concurrent pairs.

        Called under the mailbox lock (the only place that can see the
        full alternate set atomically with the match decision); only
        leaf locks (mpit, report, trace ring) are taken below it.
        """
        if not isinstance(stamp, tuple) or len(stamp) != self.size:
            return  # stamp from a different world geometry: advisory only
        races = []
        if wildcard:
            for alt_src, alt_stamp in alternates:
                if alt_src == src:
                    continue
                if not isinstance(alt_stamp, tuple) \
                        or len(alt_stamp) != self.size:
                    continue
                if _concurrent(stamp, alt_stamp):
                    races.append(alt_src)
        with self._lock:
            for i, v in enumerate(stamp):
                if v > self._vec[i]:
                    self._vec[i] = v
            self._vec[self.rank] += 1
            fresh = []
            for alt_src in races:
                key = (min(src, alt_src), max(src, alt_src), tag)
                if key not in self._seen:
                    self._seen.add(key)
                    fresh.append(alt_src)
            self.races += len(fresh)
        for alt_src in fresh:
            self._report(src, alt_src, tag)

    def _report(self, src: int, alt_src: int, tag: int) -> None:
        site = getattr(self._tls, "site", None) or user_site()
        tag_s = "ANY_TAG" if tag == -1 else str(tag)
        report_add(
            f"wildcard race: recv(ANY_SOURCE, tag={tag_s}) at rank "
            f"{self.rank} matched the message from rank {src} while a "
            f"CONCURRENT message from rank {alt_src} was also eligible "
            f"(no happens-before edge between the two sends) — the match "
            f"order is nondeterministic; order the senders or receive by "
            f"explicit source [{site}]")
        _mpit.count(verify_wildcard_races=1)
        rec = _telemetry.recorder()
        if rec is not None:
            rec.emit("verify", "wildcard_race", attrs={
                "rank": self.rank, "matched_src": src,
                "concurrent_src": alt_src, "tag": tag, "site": site})
