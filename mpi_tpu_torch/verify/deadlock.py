"""Runtime deadlock detection: publish pending ops on stall, analyze the
cross-rank wait-for graph, raise :class:`~mpi_tpu_torch.errors.DeadlockError`
instead of hanging — the port's own copy of ``mpi_tpu/verify/deadlock.py``
(``make_entry`` :49, ``_analyze`` :74, ``_describe`` :86,
``check_stalled`` :100).

Only a rank inside a verified blocking wait publishes an entry.  A rank
whose host thread sits in device work — a CUDA synchronisation behind a
staging copy, an ``.item()`` after seconds of products — publishes
nothing, so the analysis counts it as able to progress, and a peer
blocked on it is never part of a closed picture.

Protocol (driven from the communicator's sliced blocking waits, the same
plumbing the FT detector rides — ``communicator._sliced_wait``):

1. A wait blocked past ``verify_stall_timeout_s`` publishes its
   pending-op entry on the world's Board: who it waits for (world
   ranks), AND/OR semantics (specific source vs ANY_SOURCE / waitany
   sets), the tag, the enclosing collective, the user call site, and a
   progress stamp (ops counter + block id + mailbox delivery count).
2. Every further check reads all peers' entries and runs the pure
   AND-OR analysis (``checker.find_deadlock``) over the blocked +
   exited ranks.
3. A positive result is CONFIRMED before raising: re-read after one
   poll slice and require every implicated entry unchanged (same block
   id, same ops count, same mailbox deliveries) — a rank that made any
   progress in between invalidates the diagnosis and the wait resumes.

The raise happens independently on every deadlocked rank (each sees the
same closed picture), so no rank is left hanging on a peer that
errored out.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from .. import mpit as _mpit
from ..checker import find_deadlock
from ..errors import DeadlockError
from .state import WorldVerify, report_add

# Cadence of full board reads while stalled (every read is P file reads
# on process worlds); the confirm pass sleeps one slice of this.
_CHECK_SLICE_S = 0.25
# A 'blocked' entry not refreshed within this window is treated as
# absent: genuinely stalled ranks republish every check slice, while a
# wait that ENDS retracts its entry promptly (success → note_progress;
# RecvTimeout/ProcFailed/Revoked → clear_published), so only leftovers
# from a rank that died mid-stall ever reach the TTL — the last-resort
# stale-entry guard.  Exited entries never expire (termination is
# forever).
_ENTRY_TTL_S = 2.0


def make_entry(world: WorldVerify, comm, targets_world: Tuple[int, ...],
               mode: str, tag: int, kind: str, coll: Optional[str],
               site: str, block_id: int) -> dict:
    return {
        "state": "blocked",
        "rank": world.rank,
        "ctx": repr(comm._ctx),
        "targets": sorted(targets_world),
        "mode": mode,
        "tag": tag,
        "kind": kind,
        "coll": coll,
        "site": site,
        "block_id": block_id,
        "ops": world.ops,
        "deliveries": getattr(world.t.mailbox, "deliveries", 0),
        "pending": [list(p) for p in world.t.mailbox.pending_summary()[:8]],
    }


def _stamp(entry: dict) -> tuple:
    return (entry.get("state"), entry.get("block_id"), entry.get("ops"),
            entry.get("deliveries"))


def _analyze(tables: Dict[int, dict], size: int):
    waits = {}
    exited = []
    for r, e in tables.items():
        if e.get("state") == "exited":
            exited.append(r)
        elif (e.get("state") == "blocked"
              and e.get("_age_s", 0.0) <= _ENTRY_TTL_S):
            waits[r] = (e.get("mode", "AND"), tuple(e.get("targets", ())))
    return find_deadlock(waits, range(size), exited=exited), tables, exited


def _describe(r: int, e: dict) -> str:
    if e.get("state") == "exited":
        return f"rank {r}: exited (program returned / finalized)"
    coll = f" [in {e['coll']}]" if e.get("coll") else ""
    src = e.get("targets", ())
    src_s = (f"source={src[0]}" if e.get("mode") == "AND" and len(src) == 1
             else f"sources={list(src)} ({e.get('mode')})")
    pend = e.get("pending") or []
    pend_s = (f"; {len(pend)} unmatched message(s) queued "
              f"{[tuple(p) for p in pend[:4]]}" if pend else "")
    return (f"rank {r}: blocked in {e.get('kind', 'recv')}({src_s}, "
            f"tag={e.get('tag')}){coll} at {e.get('site')}{pend_s}")


def check_stalled(world: WorldVerify, comm, targets_world: Tuple[int, ...],
                  mode: str, tag: int, kind: str, coll: Optional[str],
                  site: str, block_id: int) -> None:
    """One stalled-wait tick: (re)publish our pending op, and at the
    check cadence run the wait-for analysis; raises DeadlockError when a
    confirmed cycle/knot includes this rank.  Returning means 'keep
    waiting' — the picture is still open."""
    now = time.monotonic()
    if world.published and now - world._last_check < _CHECK_SLICE_S:
        # the common stalled tick: two comparisons, no entry build, no
        # board traffic — this runs every 50ms slice while blocked
        return
    entry = make_entry(world, comm, targets_world, mode, tag, kind, coll,
                       site, block_id)
    if not world.published:
        world.published = True
        world.board.publish(world.rank, entry)
    if now - world._last_check < _CHECK_SLICE_S:
        return
    world._last_check = now
    # our own entry may have gone stale (ops advanced by sends): refresh
    world.board.publish(world.rank, entry)
    deadlocked, tables, exited = _analyze(world.board.read_all(), world.size)
    if world.rank not in deadlocked:
        return
    # confirm: one slice later the implicated picture must be unchanged
    stamps = {r: _stamp(tables[r]) for r in deadlocked if r in tables}
    for r in exited:
        stamps.setdefault(r, ("exited", None, None, None))
    time.sleep(_CHECK_SLICE_S)
    deadlocked2, tables2, _ = _analyze(world.board.read_all(), world.size)
    if world.rank not in deadlocked2 or set(deadlocked2) != set(deadlocked):
        return
    for r, s in stamps.items():
        if r not in tables2 or _stamp(tables2[r]) != s:
            return  # somebody moved: not a closed picture after all
    ranks = sorted(set(deadlocked) | (set(exited) & {
        t for r in deadlocked for t in tables[r].get("targets", ())}))
    lines = [_describe(r, tables2.get(r, tables.get(r, {"state": "exited"})))
             for r in ranks]
    msg = ("deadlock detected: wait-for cycle/knot across "
           f"{len(ranks)} rank(s):\n  " + "\n  ".join(lines))
    _mpit.count(verify_deadlocks=1)
    report_add(msg)
    raise DeadlockError(msg, ranks=ranks,
                        table={r: tables2.get(r, tables.get(r)) for r in ranks})
