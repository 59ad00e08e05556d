"""Call-time check of communication schedules, and the verifier's pure
analyses.

Own copy of ``mpi_tpu/checker.py:23-169``: ``ScheduleError`` and
``validate_perm`` (every rank permutation the SPMD communicator emits must
be a partial permutation, checked when the collective is called),
``validate_rounds``, ``find_deadlock`` (the AND-OR wait-for analysis of
the runtime deadlock detector, ``verify/deadlock.py``) and
``verify_matching`` (per-rank send/recv logs cross-checked for unmatched
traffic, with the recording transport of ``trace.py``).
"""

from __future__ import annotations

from collections import Counter, deque
from typing import Dict, Iterable, List, Sequence, Tuple

Pair = Tuple[int, int]


class ScheduleError(ValueError):
    """A communication schedule is structurally invalid."""


def validate_perm(pairs: Iterable[Pair], size: int) -> None:
    """Raise ScheduleError unless ``pairs`` is a partial permutation over
    ``size`` ranks (no duplicate source, no duplicate destination, every
    endpoint in range)."""
    pairs = list(pairs)
    srcs = Counter(s for s, _ in pairs)
    dsts = Counter(d for _, d in pairs)
    for s, d in pairs:
        if not (0 <= s < size and 0 <= d < size):
            raise ScheduleError(f"pair ({s}, {d}) out of range for size {size}")
    dup_s = [r for r, c in srcs.items() if c > 1]
    dup_d = [r for r, c in dsts.items() if c > 1]
    if dup_s or dup_d:
        raise ScheduleError(
            f"not a partial permutation: duplicate sources {dup_s}, "
            f"duplicate destinations {dup_d}"
        )


def validate_rounds(rounds: Sequence[Sequence[Pair]], size: int) -> None:
    for i, pairs in enumerate(rounds):
        try:
            validate_perm(pairs, size)
        except ScheduleError as e:
            raise ScheduleError(f"round {i}: {e}") from e


def find_deadlock(waits: Dict[int, Tuple[str, Sequence[int]]],
                  ranks: Iterable[int],
                  exited: Iterable[int] = ()) -> List[int]:
    """AND-OR wait-for-graph analysis: the pure core of the runtime
    deadlock detector (``verify/deadlock.py``) — same model as the
    MUST-class MPI verifiers.

    ``waits[r] = (mode, targets)`` describes a *blocked* rank: with
    ``mode='AND'`` (a specific-source recv, a waitall set) r needs EVERY
    target to progress; with ``mode='OR'`` (an ANY_SOURCE recv, a
    waitany set) ANY progressing target can release it.  ``ranks`` is
    the whole world; ``exited`` ranks have terminated and can never send
    again.  Returns the sorted list of ranks proven deadlocked: the
    greatest set of blocked ranks none of whose release conditions can
    be met by a rank outside it (a cycle for AND edges, a knot for OR
    sets).  Ranks neither blocked nor exited are assumed able to
    progress — the analysis never false-positives on a slow peer, only
    on a closed blocking picture."""
    ranks = set(ranks)
    exited = set(exited) & ranks
    progressing = ranks - set(waits) - exited
    changed = True
    while changed:
        changed = False
        for r, (mode, targets) in waits.items():
            if r in progressing:
                continue
            targets = [t for t in targets if t in ranks and t != r]
            if not targets:
                # nothing known about the wait: assume it can progress
                progressing.add(r)
                changed = True
                continue
            ok = (any(t in progressing for t in targets) if mode == "OR"
                  else all(t in progressing for t in targets))
            if ok:
                progressing.add(r)
                changed = True
    return sorted(r for r in waits if r not in progressing)


def verify_matching(logs: Sequence[Sequence[tuple]],
                    strict_fifo: bool = True) -> List[str]:
    """Cross-check per-rank communication logs for unmatched traffic.

    ``logs[r]`` is rank r's ordered op log; entries are tuples
    ``('send', dst, tag)`` or ``('recv', src, tag)`` (src/tag may be the
    wildcard -1).  Returns a list of human-readable problems (empty =
    clean): sends with no matching recv, recvs with no matching send.

    ``strict_fifo=True`` (default): a specific-tag recv must match the
    HEAD of its (src, dst) channel — a recv whose tag only matches a
    deeper send is flagged.  MPI's envelope semantics permit skipping
    differently-tagged sends, and this library's Mailbox implements that;
    but a program that *relies* on it deadlocks on any strict-FIFO
    channel transport and reorders silently elsewhere, which is exactly
    the class of bug a sanitizer exists to flag (head-only matching).
    Pass ``strict_fifo=False`` to check
    against pure MPI envelope semantics instead (first send with the
    SAME tag on the channel — per-(src, tag) FIFO).
    """
    problems: List[str] = []
    size = len(logs)
    # channel (src, dst) -> deque of send tags, in order
    sends: dict = {}
    for r, log in enumerate(logs):
        for op in log:
            if op[0] == "send":
                _, dst, tag = op
                sends.setdefault((r, dst), deque()).append(tag)
    for r, log in enumerate(logs):
        for op in log:
            if op[0] != "recv":
                continue
            _, src, tag = op
            candidates = (
                [(s, r) for s in range(size)] if src == -1 else [(src, r)]
            )
            matched = False
            # pass 1: a channel whose HEAD matches — legal in both modes
            # (scan ALL candidates first so a wildcard recv is not blamed
            # for skipping a queue when another sender's head matches)
            for ch in candidates:
                q = sends.get(ch)
                if q and (tag == -1 or q[0] == tag):
                    q.popleft()
                    matched = True
                    break
            if not matched:
                # pass 2: deep same-tag match (MPI envelope semantics;
                # flagged in strict mode — relies on tag reordering)
                for ch in candidates:
                    q = sends.get(ch)
                    if q and tag in q:
                        if strict_fifo:
                            problems.append(
                                f"rank {r}: recv(src={src}, tag={tag}) "
                                f"matches send #{list(q).index(tag)} on "
                                f"channel {ch[0]}->{ch[1]} but the channel "
                                f"head has tag {q[0]} — out-of-FIFO match "
                                f"(deadlocks a strict-FIFO transport; "
                                f"reorder sends/recvs or verify with "
                                f"strict_fifo=False)")
                        q.remove(tag)
                        matched = True
                        break
            if not matched:
                problems.append(f"rank {r}: recv(src={src}, tag={tag}) has no matching send")
    for (s, d), q in sends.items():
        for tag in q:
            problems.append(f"rank {s}: send(dst={d}, tag={tag}) was never received")
    return problems
