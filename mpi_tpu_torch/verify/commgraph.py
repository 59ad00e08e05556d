"""Whole-tree send/recv/collective match graph for mpilint v2.

:mod:`mpi_tpu_torch.verify.dataflow` turns a module into analysis roots — flat
operation lists with guard chains and environment snapshots.  This
module instantiates each root against a small **model world**: for every
model rank r in ``range(N)`` it evaluates each operation's guard chain
with ``comm.rank := r`` and resolves the peer/tag/count expressions,
producing the per-rank operation schedule an SPMD execution of that code
would follow.  The match rules then read directly off the schedules:

* **MPL001** — the per-rank sequences of collective names diverge: some
  rank reaches a collective the others never post (hang) or posts a
  different collective at the same position (mismatch).
* **MPL002** — two ranks whose first operation toward each other is a
  blocking send, and both later receive from each other: head-to-head
  rendezvous deadlock.
* **MPL003** — a matched send/recv pair whose receive count is smaller
  than the send count (the receive truncates the message).
* **MPL007** — a send and an exact-tag receive on the same channel that
  can never match each other's tag.
* **MPL009** — an ``ANY_SOURCE`` receive with two or more eligible
  senders carrying a matching tag: the match order is a race (the
  runtime verifier observes the same race dynamically via vector
  clocks).

Undecidability is always silence: an operation whose guard chain does
not fully evaluate at every model rank is dropped from the model
uniformly (so a guard on a *different* communicator's rank — the
``if self.intra.rank == 0: self.leaders.allgather(...)`` leader pattern
— never produces a finding).  Operations inside rank-dependent loops are
likewise excluded here; they surface through MPL008 instead.

The port's own copy of ``mpi_tpu/verify/commgraph.py`` (:1-358), pure ``ast``
code with its rules unchanged.
"""

from __future__ import annotations

import ast
from typing import Dict, List, NamedTuple, Optional, Tuple

from .dataflow import (
    Guard,
    Op,
    RootOps,
    eval_expr,
    resolve_comm,
)

ANY = -1            # wildcard sentinel (matches ANY_SOURCE / ANY_TAG)
_MAX_WORLD = 12     # model-world clamp: literals past this stay unexercised
_MIN_WORLD = 3      # always at least 3 ranks (MPL009 needs 2 senders + 1)


class CGFinding(NamedTuple):
    line: int
    code: str
    msg: str


class _Inst(NamedTuple):
    """One operation as executed by one model rank."""
    op: Op
    rank: int
    peer: Optional[int]   # resolved dest/source; ANY for wildcard; None n/a
    tag: Optional[int]    # resolved tag; ANY for ANY_TAG
    count: Optional[int]
    order: int            # program-order index within the root


# -- model construction ------------------------------------------------------

def _guard_comm(guards: Tuple[Guard, ...]) -> Optional[str]:
    """The communicator whose ``.rank`` the innermost guard mentions —
    used to re-key ``MPI_Send``-style function ops that carry no comm."""
    for g in reversed(guards):
        for n in ast.walk(g.test):
            if isinstance(n, ast.Attribute) \
                    and n.attr in ("rank", "world_rank"):
                key = resolve_comm(n.value, g.env)
                if key is not None:
                    return key
    return None


def _rekey(op: Op) -> Op:
    if op.comm != "<world>":
        return op
    key = _guard_comm(op.guards)
    return op._replace(comm=key) if key is not None else op


def _literals(op: Op) -> List[int]:
    out: List[int] = []
    nodes: List[ast.AST] = [g.test for g in op.guards]
    if op.peer is not None:
        nodes.append(op.peer)
    if op.tag is not None:
        nodes.append(op.tag)
    for node in nodes:
        for n in ast.walk(node):
            if isinstance(n, ast.Constant) and isinstance(n.value, int) \
                    and not isinstance(n.value, bool):
                out.append(n.value)
    return out


def _world_size(ops: List[Op]) -> int:
    lits = [v for op in ops for v in _literals(op) if 0 <= v < _MAX_WORLD]
    hi = max(lits) if lits else 0
    return min(_MAX_WORLD, max(_MIN_WORLD, hi + 2))


def _guards_decide(op: Op, comm: str, rank: int, size: int) -> Optional[bool]:
    """True/False: op does/does not execute at this rank; None: some
    guard is undecidable."""
    for g in op.guards:
        v = eval_expr(g.test, g.env, comm, rank, size)
        if v is None:
            return None
        if bool(v) != g.polarity:
            return False
    return True


def _direction(op: Op) -> Optional[str]:
    """'send' / 'recv' / 'coll' for matching purposes (nonblocking ops
    keep their direction)."""
    if op.kind == "coll":
        return "coll"
    if op.kind in ("send", "recv"):
        return op.kind
    low = op.name.lower()
    if "recv" in low and "send" not in low:
        return "recv"
    if "send" in low:
        return "send"
    return None


def _instantiate(ops: List[Op], comm: str,
                 size: int) -> Optional[Dict[int, List[_Inst]]]:
    """Per-rank schedules, or None when the comm has no usable model."""
    by_rank: Dict[int, List[_Inst]] = {r: [] for r in range(size)}
    any_usable = False
    for order, op in enumerate(ops):
        if op.in_rank_loop:
            continue  # surfaced via MPL008, not the match graph
        decisions = [_guards_decide(op, comm, r, size) for r in range(size)]
        if any(d is None for d in decisions):
            continue  # undecidable guard: drop the op uniformly
        direction = _direction(op)
        for r, execute in enumerate(decisions):
            if not execute:
                continue
            peer = tag = count = None
            if direction in ("send", "recv"):
                if op.peer is None:
                    peer = ANY if direction == "recv" else None
                else:
                    peer = eval_expr(op.peer, op.env, comm, r, size)
                if op.tag is None:
                    tag = 0 if direction == "send" else ANY
                else:
                    tag = eval_expr(op.tag, op.env, comm, r, size)
                if op.count is not None:
                    count = eval_expr(op.count, op.env, comm, r, size)
                    if not isinstance(count, int):
                        count = None
                # out-of-world peers (e.g. 1 - rank at rank 2) drop out
                if peer is None or tag is None:
                    continue
                if direction == "send" and not (0 <= peer < size):
                    continue
                if direction == "recv" and peer != ANY \
                        and not (0 <= peer < size):
                    continue
            by_rank[r].append(_Inst(op, r, peer, tag, count, order))
            any_usable = True
    return by_rank if any_usable else None


# -- rules -------------------------------------------------------------------

def _rule_collective_divergence(comm: str, size: int,
                                by_rank: Dict[int, List[_Inst]],
                                out: List[CGFinding]) -> None:
    seqs = {r: [i for i in by_rank[r] if i.op.kind == "coll"]
            for r in range(size)}
    if not any(seqs.values()):
        return
    depth = max(len(s) for s in seqs.values())
    for idx in range(depth):
        names = {r: (seqs[r][idx].op.name if idx < len(seqs[r]) else None)
                 for r in range(size)}
        if len(set(names.values())) <= 1:
            continue
        # first divergence: report each distinct collective posted here
        seen_lines = set()
        for r in range(size):
            if names[r] is None:
                continue
            inst = seqs[r][idx]
            if inst.op.line in seen_lines:
                continue
            seen_lines.add(inst.op.line)
            here = sorted(q for q in range(size) if names[q] == names[r])
            absent = sorted(q for q in range(size) if q not in here)
            out.append(CGFinding(
                inst.op.line, "MPL001",
                f"collective {comm}.{inst.op.name}() is reached by "
                f"rank(s) {here} but not rank(s) {absent} under the "
                f"resolved rank conditions; ranks diverge from the "
                f"collective schedule (hang or collective mismatch)"))
        return  # only the first divergence is actionable


def _involving(insts: List[_Inst], peer: int) -> List[_Inst]:
    out = []
    for i in insts:
        d = _direction(i.op)
        if d == "send" and i.peer == peer:
            out.append(i)
        elif d == "recv" and (i.peer == peer or i.peer == ANY):
            out.append(i)
    return out


def _rule_send_send_cycle(comm: str, size: int,
                          by_rank: Dict[int, List[_Inst]],
                          out: List[CGFinding]) -> None:
    for a in range(size):
        for b in range(a + 1, size):
            ia = _involving(by_rank[a], b)
            ib = _involving(by_rank[b], a)
            if not ia or not ib:
                continue
            fa, fb = ia[0], ib[0]
            if not (fa.op.kind == "send" and fb.op.kind == "send"):
                continue  # nonblocking sends don't rendezvous-deadlock
            if not any(_direction(i.op) == "recv" for i in ia[1:]) \
                    or not any(_direction(i.op) == "recv" for i in ib[1:]):
                continue
            line = min(fa.op.line, fb.op.line)
            out.append(CGFinding(
                line, "MPL002",
                f"ranks {a} and {b} both blocking-send to each other "
                f"before receiving (head-to-head rendezvous deadlock); "
                f"use {comm}.sendrecv()"))


def _rule_channel_rules(comm: str, size: int,
                        by_rank: Dict[int, List[_Inst]],
                        out: List[CGFinding]) -> None:
    """Per directed channel (src -> dst): order-respecting tag matching,
    then MPL003 on matched pairs and MPL007 on the unmatchable rest."""
    for s in range(size):
        sends_all = [i for i in by_rank[s] if _direction(i.op) == "send"]
        for d in range(size):
            if s == d:
                continue
            sends = [i for i in sends_all if i.peer == d]
            recvs = [i for i in by_rank[d]
                     if _direction(i.op) == "recv"
                     and (i.peer == s or i.peer == ANY)]
            if not sends:
                continue
            unmatched_recvs = list(recvs)
            unmatched_sends = []
            for snd in sends:
                hit = None
                for j, rcv in enumerate(unmatched_recvs):
                    if rcv.tag == ANY or rcv.tag == snd.tag:
                        hit = j
                        break
                if hit is None:
                    unmatched_sends.append(snd)
                    continue
                rcv = unmatched_recvs.pop(hit)
                if rcv.count is not None and snd.count is not None \
                        and rcv.count < snd.count:
                    out.append(CGFinding(
                        rcv.op.line, "MPL003",
                        f"recv count {rcv.count} truncates the "
                        f"message: the matching send (line "
                        f"{snd.op.line}) sends {snd.count} elements"))
            exact_left = [r for r in unmatched_recvs
                          if r.tag != ANY and r.peer == s]
            if unmatched_sends and exact_left:
                snd, rcv = unmatched_sends[0], exact_left[0]
                out.append(CGFinding(
                    rcv.op.line, "MPL007",
                    f"tag mismatch on {comm} channel {s}->{d}: send "
                    f"at line {snd.op.line} uses tag {snd.tag} but "
                    f"this recv expects tag {rcv.tag}; the pair can "
                    f"never match"))


def _rule_wildcard_race(comm: str, size: int,
                        by_rank: Dict[int, List[_Inst]],
                        out: List[CGFinding]) -> None:
    seen_lines = set()
    for d in range(size):
        for rcv in by_rank[d]:
            if _direction(rcv.op) != "recv" or rcv.peer != ANY:
                continue
            if rcv.op.line in seen_lines:
                continue
            senders = sorted({
                s for s in range(size) if s != d
                for i in by_rank[s]
                if _direction(i.op) == "send" and i.peer == d
                and (rcv.tag == ANY or i.tag == rcv.tag)})
            if len(senders) >= 2:
                seen_lines.add(rcv.op.line)
                tag_s = "ANY_TAG" if rcv.tag == ANY else str(rcv.tag)
                out.append(CGFinding(
                    rcv.op.line, "MPL009",
                    f"ANY_SOURCE recv (tag {tag_s}) has {len(senders)} "
                    f"eligible senders {senders} on {comm}: the match "
                    f"order is a nondeterministic race (run under "
                    f"verify mode to observe it via vector clocks)"))


# -- entry points ------------------------------------------------------------

def analyze_root(root: RootOps) -> List[CGFinding]:
    findings: List[CGFinding] = []
    by_comm: Dict[str, List[Op]] = {}
    for op in root.ops:
        op = _rekey(op)
        if op.comm in ("self", "<world>"):
            # `self`-keyed ops are a communicator implementing itself,
            # not an SPMD program over one; un-keyable MPI_* calls have
            # no model either way
            continue
        by_comm.setdefault(op.comm, []).append(op)
    for comm, ops in by_comm.items():
        size = _world_size(ops)
        by_rank = _instantiate(ops, comm, size)
        if by_rank is None:
            continue
        _rule_collective_divergence(comm, size, by_rank, findings)
        _rule_send_send_cycle(comm, size, by_rank, findings)
        _rule_channel_rules(comm, size, by_rank, findings)
        _rule_wildcard_race(comm, size, by_rank, findings)
    return findings


def analyze(roots: List[RootOps]) -> List[CGFinding]:
    """Match-graph findings for all roots of one module, deduplicated by
    (line, code)."""
    seen = set()
    out: List[CGFinding] = []
    for root in roots:
        for f in analyze_root(root):
            key = (f.line, f.code)
            if key not in seen:
                seen.add(key)
                out.append(f)
    return out
