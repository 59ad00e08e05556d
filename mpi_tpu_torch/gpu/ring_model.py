"""Discrete-event model of the pipelined ring protocols of the Pallas
kernels: the port's own copy of ``mpi_tpu/tpu/ring_model.py`` (the op
vocabulary :63-96, ``_send_chunk`` / ``_accum_chunk`` :99-105,
``device_program`` :108, ``RingSim`` :180, ``attention_program`` :507,
``AttentionSim`` :540, ``_explore`` :684, ``explore_attention`` :723,
``attention_bwd_program`` :736, ``AttentionBwdSim`` :776,
``explore_attention_bwd`` :879, ``explore_all`` :887).  Standard library
only; the code below is the reference's, unchanged but for four
comments (three cited its review notes).

**What it models.**  Each program is the literal op sequence of one
device in a pipelined TPU kernel (semaphore waits and signals, split
RDMA completions, the landing-slot accumulates), run under adversarial
event orderings and explored exhaustively for small rings, against five
invariants: no deadlock, no landing-slot overwrite, no source mutation
in flight, semaphores that drain to zero, and correct data.

* ``device_program`` / ``RingSim``: K1, the credit-pipelined ring of
  ``mpi_tpu/tpu/pallas_ring.py:_kernel`` (:124, its pipelined body
  :211-301).  The port's K1 folds in that ring's order: chunk ``a`` of a
  group starts at position ``a - s*rot`` and walks in steps of ``s``,
  one fold ``own (+) received`` per hop, as ``_send_chunk`` and
  ``_accum_chunk`` give it.  Its geometry is ``mpi_tpu_torch/gpu/ring.py``
  (``_segments`` :77, ``_flows`` :90, ``_geometry`` :101), its plain
  version ``_run_schedule`` (:179), and the kernel ``csrc/ring.cu``
  (``ring_fold``, ``ring_gather`` and their ``_ptrs`` forms).
  ``tests/test_torch_ring_model.py`` folds float32 data in the model's
  order and holds it bitwise against ``allreduce_plain`` and
  ``reduce_scatter_plain``.
* ``attention_program`` / ``AttentionSim``: K2's K/V circulation
  (``mpi_tpu/tpu/pallas_attention.py:_kernel`` :367, behind
  ``_mk_barrier`` :177): every device folds every block once, in ring
  order ``my, my-1, ..., my-P+1``, the order ``csrc/attention.cu``
  reads the blocks in.
* ``attention_bwd_program`` / ``AttentionBwdSim``: K3's dK/dV
  circulation (``pallas_attention.py:_bwd_kernel`` :617), fold before
  forward and a home arrival that carries every rank's contribution;
  ``csrc/attention_bwd.cu`` sums dK/dV over the same ring order.

**What it does not model.**  On one card all ranks' blocks share one
memory and no chunk travels: the port's kernels read each input where it
lies and have no RDMA, landing slot, credit or barrier, so no port
kernel runs a pipelined path yet.  What the model holds for the port is
the order of the folds.  A pipelined ring between cards, with
release/acquire flags in place of the Pallas semaphores, belongs to the
multi-card kernel (ROADMAP Queue 1 item 14b), whose flag-and-credit
program will be added here beside these.

The reference's own description of the model follows.

**Faithfulness.**  ``device_program`` emits, per device, the literal
sequence of semaphore/DMA operations of ``_kernel`` with
``pipelined=True`` (each op is annotated with the kernel construct it mirrors).  The kernel's pipelined control flow is branch-free —
every wait/signal/DMA is unconditional once (P, K, collective) are fixed —
so the program IS a static op list, and the model cannot diverge from the
kernel by taking a different branch.

**Grouped rings**: a split communicator runs one independent ring per
group with per-device (grank, left, right) SMEM params — a pure
relabeling of device ids.  Each group's protocol is therefore isomorphic
to a full ring of the group's size, so the (P, K) coverage below covers
grouped rings of the same geometry; groups share no semaphores, buffers,
or barrier signals (each device signals only its own ring's neighbors).

**Semaphore semantics** (Mosaic's): counting semaphores; ``signal`` may
target a remote device; ``wait(n)`` blocks until value ≥ n, then atomically
subtracts n.  A remote copy is split into two independently-scheduled
completions: *leave* (source buffer free → send_sem increments on the
sender) and *arrive* (bytes written at the destination → recv_sem
increments on the receiver), with leave ≤ arrive per copy and NO ordering
across copies — the adversary controls all interleaving.

**Invariants checked** (the kernel's correctness argument):

1. *No deadlock*: from every reachable state some event is enabled until
   all devices exit.  (The semaphore graph is single-waiter — each
   semaphore is waited on by exactly one device — so the system is a
   conflict-free Petri net and deadlock-freedom is schedule-independent;
   the exhaustive search below verifies this for small (P, K) rather than
   assuming it.)
2. *No landing-slot overwrite*: an RDMA never arrives into a comm-buffer
   (parity, segment) slot whose previous payload has not been accumulated
   — the credit protocol's whole job.
3. *No source mutation in flight*: no device writes a buffer region that
   is the source of one of its own started-but-not-left RDMAs, and no RDMA
   arrives into a region concurrently being read as an RDMA source.
4. *Semaphores drain to zero* at exit (Mosaic's own hardware invariant —
   leftover counts corrupt the next collective using the same ids).
5. *Data correctness* under every explored ordering: payloads are modeled
   as sets of (rank, chunk, segment) contributions; after the allreduce
   every device holds every contribution, after the reduce-scatter rank r
   holds all contributions to chunk r.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Op vocabulary (one-to-one with the kernel's pltpu calls)
# ---------------------------------------------------------------------------

# sem keys: ("send", slot, seg) / ("recv", slot, seg) / ("credit", slot, seg)
# / ("bar",) — all owned (waited on) by exactly one device.
SemKey = Tuple


@dataclass(frozen=True)
class Wait:
    sem: SemKey
    n: int


@dataclass(frozen=True)
class Signal:          # pltpu.semaphore_signal(dev=target)
    target: int        # absolute device id
    sem: SemKey
    inc: int = 1


@dataclass(frozen=True)
class DmaStart:        # make_async_remote_copy(...).start()
    u: int
    seg: int


@dataclass(frozen=True)
class Accum:           # the VMEM accumulate of landing slot (u%2, seg)
    u: int
    seg: int


class ProtocolViolation(AssertionError):
    pass


def _send_chunk(my: int, u: int, P: int, rot: int, dirn: int) -> int:
    # pallas_ring._kernel send_chunk; dirn=-1 is the mirror ring
    return (my - u + rot) % P if dirn > 0 else (my + u - rot) % P

def _accum_chunk(my: int, u: int, P: int, rot: int, dirn: int) -> int:
    # pallas_ring._kernel accum_chunk
    return (my - u - 1 + rot) % P if dirn > 0 else (my + u + 1 - rot) % P


def device_program(my: int, P: int, K: int, *, rot: int,
                   allgather: bool, rs: bool = True,
                   dirs: Optional[Tuple[int, ...]] = None) -> List[object]:
    """The pipelined ``_kernel`` body for device ``my`` as a static op list
    (the pipelined=True body of pallas_ring._kernel).

    ``dirs`` gives the direction of each flow (+1 right-going, -1
    left-going mirror ring); default: K unidirectional flows.  A flow's
    credit goes to its upstream writer — left for +1, right for -1."""
    left, right = (my - 1) % P, (my + 1) % P
    dirs = dirs or (1,) * K
    F = len(dirs)
    # rs=False models the kernel's ALLGATHER-ONLY mode (zero RS steps)
    n_rs = P - 1 if rs else 0
    n_steps = n_rs + (P - 1 if allgather else 0)
    ops: List[object] = []

    # entry neighbor_barrier()
    ops += [Signal(left, ("bar",)), Signal(right, ("bar",)),
            Wait(("bar",), 2)]
    # warm-up sends, u=0 (no dependency: step-0 payload is original data)
    for fi in range(F):
        ops.append(DmaStart(0, fi))
    for u in range(n_steps):
        slot = u % 2
        for fi in range(F):
            writer = left if dirs[fi] > 0 else right
            ops.append(Wait(("recv", slot, fi), 1))      # rdma(u).wait_recv()
            if u < n_rs:
                ops.append(Accum(u, fi))                 # VMEM accumulate
            if u + 2 < n_steps:                          # credit the writer
                ops.append(Signal(writer, ("credit", slot, fi)))
            if u + 1 < n_steps:                          # start_send(u + 1):
                if u + 1 >= 2:                           # wait_send + credit gate
                    ops.append(Wait(("send", (u + 1) % 2, fi), 1))
                    ops.append(Wait(("credit", (u + 1) % 2, fi), 1))
                ops.append(DmaStart(u + 1, fi))
    # drain: the two newest sends per flow are still in flight
    for fi in range(F):
        if n_steps >= 2:
            ops.append(Wait(("send", (n_steps - 2) % 2, fi), 1))
        ops.append(Wait(("send", (n_steps - 1) % 2, fi), 1))
    # exit neighbor_barrier()
    ops += [Signal(left, ("bar",)), Signal(right, ("bar",)),
            Wait(("bar",), 2)]
    return ops


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------

Region = Tuple[int, int]  # (chunk, seg) of a device's out buffer


@dataclass
class Dma:
    src: int
    u: int
    seg: int
    phase: str                  # "started" -> "left" -> gone on arrive
    payload: FrozenSet
    src_region: Region
    dst: int
    # destination: RS -> comm slot (u%2, seg); AG -> out region
    dst_slot: Optional[Tuple[int, int]]
    dst_region: Optional[Region]

    def key(self):
        return (self.src, self.u, self.seg, self.phase)


class RingSim:
    """One simulation run of P devices under a pluggable event policy."""

    def __init__(self, P: int, K: int, *, rot: int, allgather: bool,
                 rs: bool = True,
                 track_data: bool = True,
                 program_override=None,
                 dirs: Optional[Tuple[int, ...]] = None):
        if P < 2:
            raise ValueError("ring needs P >= 2")
        self.P, self.K = P, K
        self.dirs = tuple(dirs) if dirs else (1,) * K
        F = len(self.dirs)
        self.rot, self.allgather, self.rs = rot, allgather, rs
        self.n_rs = P - 1 if rs else 0
        self.n_steps = self.n_rs + (P - 1 if allgather else 0)
        prog_fn = program_override or device_program
        kw = dict(rot=rot, allgather=allgather, dirs=self.dirs)
        import inspect

        sig = inspect.signature(prog_fn)
        if "rs" in sig.parameters or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values()):
            kw["rs"] = rs
        elif not rs:
            raise ValueError("program_override does not model rs=False")
        self.progs = [prog_fn(d, P, K, **kw) for d in range(P)]
        self.pc = [0] * P
        self.sems: List[Dict[SemKey, int]] = [dict() for _ in range(P)]
        self.dmas: List[Dma] = []
        self.track_data = track_data
        # out[d][(chunk, flow)] = set of contributions (rank, chunk, flow)
        # (flows own disjoint tile ranges, so a flow index IS a region)
        # allreduce/RS: every chunk holds the device's own contribution;
        # ag-only: only the device's OWN chunk starts populated
        self.out = [{(c, s): (frozenset([(d, c, s)])
                              if rs or c == d else frozenset())
                     for c in range(P) for s in range(F)}
                    for d in range(P)]
        # comm[d][(slot, flow)] = (state, payload); landing double buffer
        self.comm = [{(sl, s): ("empty", frozenset())
                      for sl in range(2) for s in range(F)}
                     for d in range(P)]
        self.trace: List[str] = []
        # -- link-occupancy tracking ---------------------------------------
        # Physical link i joins devices i and i+1; a right-going RDMA from
        # src rides link src, a left-going one from src rides link src-1.
        # Counters sample occupancy once per executed event ("tick"):
        # how often each direction had an RDMA in flight, how often BOTH
        # did simultaneously (the full-duplex overlap the bidirectional
        # design claims), and the same per physical link.
        self.ticks = 0
        self.dir_busy_ticks = {+1: 0, -1: 0}
        self.both_dir_ticks = 0
        self.link_overlap_ticks = [0] * P

    # -- event enumeration --------------------------------------------------

    def device_enabled(self, d: int) -> bool:
        if self.pc[d] >= len(self.progs[d]):
            return False
        op = self.progs[d][self.pc[d]]
        if isinstance(op, Wait):
            return self.sems[d].get(op.sem, 0) >= op.n
        return True

    def enabled_events(self) -> List[Tuple]:
        ev: List[Tuple] = [("dev", d) for d in range(self.P)
                           if self.device_enabled(d)]
        for i, dma in enumerate(self.dmas):
            if dma.phase == "started":
                ev.append(("leave", i))
            elif dma.phase == "left":
                ev.append(("arrive", i))
        return ev

    # -- event execution ----------------------------------------------------

    def _mk_dma(self, d: int, u: int, fi: int) -> Dma:
        P, rot = self.P, self.rot
        dirn = self.dirs[fi]
        target = (d + 1) % P if dirn > 0 else (d - 1) % P
        c = _send_chunk(d, u, P, rot, dirn)
        payload = self.out[d][(c, fi)] if self.track_data else frozenset()
        if u < self.n_rs:
            return Dma(d, u, fi, "started", payload, (c, fi), target,
                       dst_slot=(u % 2, fi), dst_region=None)
        return Dma(d, u, fi, "started", payload, (c, fi), target,
                   dst_slot=None, dst_region=(c, fi))

    def step(self, event: Tuple) -> None:
        kind = event[0]
        if kind == "dev":
            d = event[1]
            op = self.progs[d][self.pc[d]]
            self.pc[d] += 1
            if isinstance(op, Wait):
                have = self.sems[d].get(op.sem, 0)
                if have < op.n:
                    raise ProtocolViolation(
                        f"dev{d} executed un-enabled wait {op}")
                self.sems[d][op.sem] = have - op.n
            elif isinstance(op, Signal):
                t = op.target
                self.sems[t][op.sem] = self.sems[t].get(op.sem, 0) + op.inc
            elif isinstance(op, DmaStart):
                self.dmas.append(self._mk_dma(d, op.u, op.seg))
            elif isinstance(op, Accum):
                self._accum(d, op.u, op.seg)
            self.trace.append(f"dev{d}:{op}")
        elif kind == "leave":
            dma = self.dmas[event[1]]
            if self.track_data and \
                    self.out[dma.src][dma.src_region] != dma.payload:
                raise ProtocolViolation(
                    f"source region {dma.src_region} of dev{dma.src} step "
                    f"{dma.u} mutated while the RDMA was reading it "
                    f"(invariant 3)")
            dma.phase = "left"
            sk = ("send", dma.u % 2, dma.seg)
            self.sems[dma.src][sk] = self.sems[dma.src].get(sk, 0) + 1
            self.trace.append(f"leave:{dma.src}->{dma.dst} u={dma.u} "
                              f"seg={dma.seg}")
        elif kind == "arrive":
            i = event[1]
            dma = self.dmas[i]
            dst = dma.dst
            if dma.dst_slot is not None:          # RS: comm landing zone
                state, _ = self.comm[dst][dma.dst_slot]
                if state == "full":
                    raise ProtocolViolation(
                        f"RDMA u={dma.u} seg={dma.seg} from dev{dma.src} "
                        f"overwrote unconsumed landing slot {dma.dst_slot} "
                        f"on dev{dst} (invariant 2: write-before-credit)")
                self.comm[dst][dma.dst_slot] = ("full", dma.payload)
            else:                                  # AG: straight into out
                for other in self.dmas:
                    if (other is not dma and other.phase == "started"
                            and other.src == dst
                            and other.src_region == dma.dst_region):
                        raise ProtocolViolation(
                            f"AG RDMA from dev{dma.src} landed in region "
                            f"{dma.dst_region} of dev{dst} while dev{dst} "
                            f"was sending from it (invariant 3)")
                if self.track_data:
                    self.out[dst][dma.dst_region] = dma.payload
            rk = ("recv", dma.u % 2, dma.seg)
            self.sems[dst][rk] = self.sems[dst].get(rk, 0) + 1
            del self.dmas[i]
            self.trace.append(f"arrive:{dma.src}->{dst} u={dma.u} "
                              f"seg={dma.seg}")
        self._record_occupancy()

    def _record_occupancy(self) -> None:
        """Sample per-direction / per-link wire occupancy after an event.
        An RDMA occupies its link from start until arrive (the model's
        conservative in-flight window)."""
        self.ticks += 1
        busy: Dict[int, set] = {+1: set(), -1: set()}
        for dma in self.dmas:
            dirn = self.dirs[dma.seg]
            link = dma.src if dirn > 0 else (dma.src - 1) % self.P
            busy[dirn].add(link)
        for dirn in (+1, -1):
            if busy[dirn]:
                self.dir_busy_ticks[dirn] += 1
        if busy[+1] and busy[-1]:
            self.both_dir_ticks += 1
        for link in busy[+1] & busy[-1]:
            self.link_overlap_ticks[link] += 1

    def occupancy_summary(self) -> Dict[str, object]:
        """Link-occupancy evidence for the bidirectional-overlap claim
        (pallas_ring.py header: 'twice the usable line-rate'):
        ``both_dir_ticks`` counts event-ticks during which right-going
        AND left-going RDMAs were simultaneously in flight, and
        ``links_with_duplex_overlap`` how many physical links carried
        both directions at once at some point."""
        return {
            "ticks": self.ticks,
            "right_busy_ticks": self.dir_busy_ticks[+1],
            "left_busy_ticks": self.dir_busy_ticks[-1],
            "both_dir_ticks": self.both_dir_ticks,
            "links_with_duplex_overlap": sum(
                1 for t in self.link_overlap_ticks if t > 0),
            "n_links": self.P,
        }

    def _accum(self, d: int, u: int, seg: int) -> None:
        slot = (u % 2, seg)
        state, payload = self.comm[d][slot]
        if state != "full":
            raise ProtocolViolation(
                f"dev{d} accumulated empty landing slot {slot} at step {u} "
                f"(wait_recv matched a different copy)")
        ci = _accum_chunk(d, u, self.P, self.rot, self.dirs[seg])
        region = (ci, seg)
        for dma in self.dmas:
            if (dma.phase == "started" and dma.src == d
                    and dma.src_region == region):
                raise ProtocolViolation(
                    f"dev{d} step {u} accumulated into region {region} "
                    f"still being read by its own in-flight RDMA "
                    f"u={dma.u} (invariant 3)")
            if (dma.dst == d and dma.dst_region == region):
                raise ProtocolViolation(
                    f"dev{d} step {u} accumulated into region {region} "
                    f"targeted by an inbound AG RDMA from dev{dma.src} "
                    f"(invariant 3)")
        if self.track_data:
            self.out[d][region] = self.out[d][region] | payload
        self.comm[d][slot] = ("empty", frozenset())

    # -- termination + final invariants -------------------------------------

    def done(self) -> bool:
        return (all(self.pc[d] >= len(self.progs[d]) for d in range(self.P))
                and not self.dmas)

    def check_final(self) -> None:
        for d in range(self.P):
            for k, v in self.sems[d].items():
                if v != 0:
                    raise ProtocolViolation(
                        f"semaphore {k} on dev{d} = {v} at exit "
                        f"(invariant 4: must drain to zero)")
        if not self.track_data:
            return
        P, F = self.P, len(self.dirs)
        if not self.rs:
            # ag-only: chunk c everywhere = device c's original block
            for d in range(P):
                for c in range(P):
                    for s in range(F):
                        got = self.out[d][(c, s)]
                        want = frozenset([(c, c, s)])
                        if got != want:
                            raise ProtocolViolation(
                                f"allgather data wrong on dev{d} chunk {c} "
                                f"seg {s}: {sorted(got)} != {sorted(want)} "
                                f"(invariant 5)")
            return
        if self.allgather:
            for d in range(P):
                for c in range(P):
                    for s in range(F):
                        got = self.out[d][(c, s)]
                        want = frozenset((r, c, s) for r in range(P))
                        if got != want:
                            raise ProtocolViolation(
                                f"allreduce data wrong on dev{d} chunk {c} "
                                f"seg {s}: {sorted(got)} != full reduction "
                                f"(invariant 5)")
        else:
            for d in range(P):
                c = d  # rot=-1: the last RS step accumulates chunk ``my``
                for s in range(F):
                    got = self.out[d][(c, s)]
                    want = frozenset((r, c, s) for r in range(P))
                    if got != want:
                        raise ProtocolViolation(
                            f"reduce_scatter data wrong on dev{d} chunk {c} "
                            f"seg {s}: {sorted(got)} (invariant 5)")

    # -- running a simulation -----------------------------------------------

    def run(self, policy: str = "random", seed: int = 0,
            max_events: int = 1_000_000) -> None:
        """Run to completion under a scheduling policy.

        * ``random`` — uniformly random enabled event (seeded).
        * ``eager_compute`` — device ops first; DMA phases only when no
          device can move (maximum latency adversary).
        * ``lazy_lifo`` — when forced to move a DMA, move the NEWEST one
          (out-of-order completion adversary).
        * ``dma_first`` — complete DMAs as soon as possible (zero-latency).
        """
        rng = random.Random(seed)
        for _ in range(max_events):
            if self.done():
                self.check_final()
                return
            ev = self.enabled_events()
            if not ev:
                blocked = {
                    d: self.progs[d][self.pc[d]]
                    for d in range(self.P) if self.pc[d] < len(self.progs[d])}
                raise ProtocolViolation(
                    f"DEADLOCK (invariant 1): blocked={blocked} "
                    f"in-flight={[(x.src, x.u, x.seg, x.phase) for x in self.dmas]}")
            if policy == "random":
                choice = rng.choice(ev)
            elif policy == "eager_compute":
                dev = [e for e in ev if e[0] == "dev"]
                choice = rng.choice(dev) if dev else rng.choice(ev)
            elif policy == "lazy_lifo":
                dev = [e for e in ev if e[0] == "dev"]
                if dev:
                    choice = rng.choice(dev)
                else:
                    choice = max(ev, key=lambda e: e[1])
            elif policy == "dma_first":
                dma = [e for e in ev if e[0] != "dev"]
                choice = dma[0] if dma else rng.choice(ev)
            else:
                raise ValueError(policy)
            self.step(choice)
        raise ProtocolViolation("event budget exhausted (livelock?)")

    # -- exhaustive state-space search (protocol state only) ---------------

    def _snapshot(self):
        sems = tuple(tuple(sorted((k, v) for k, v in s.items() if v))
                     for s in self.sems)
        dmas = tuple(sorted(d.key() for d in self.dmas))
        slots = tuple(tuple(sorted((k, st) for k, (st, _) in c.items()
                                   if st != "empty"))
                      for c in self.comm)
        return (tuple(self.pc), sems, dmas, slots)


# ---------------------------------------------------------------------------
# Ring-attention circulation protocol (pallas_attention._kernel)
# ---------------------------------------------------------------------------


def attention_program(my: int, P: int) -> List[object]:
    """The pipelined ``pallas_attention._kernel`` body for device ``my``
    as a static op list (same one-to-one construction discipline as
    ``device_program``).  Single flow; ``Accum(a, 0)`` models the
    VMEM-copy+online-softmax fold of arrival ``a`` (a=0 → the device's
    own block, no slot involved).  Send ``u`` targets slot (u+1)%2;
    sends 0/1 are credit-free (virgin slots); the credit for slot a%2
    is signalled only after wait_send(a) — the forward must have READ
    the slot out before the writer may land arrival a+2 in it."""
    left, right = (my - 1) % P, (my + 1) % P
    ops: List[object] = [Signal(left, ("bar",)), Signal(right, ("bar",)),
                         Wait(("bar",), 2)]
    ops.append(Accum(0, 0))                       # fold own block
    if P >= 2:
        ops.append(DmaStart(0, 0))                # circulate own block
        ops.append(Wait(("send", 1, 0), 1))       # sem hygiene for send 0
    for a in range(1, P):
        slot = a % 2
        ops.append(Wait(("recv", slot, 0), 1))    # arrival a landed
        if a <= P - 2:
            if a >= 2:                            # dst slot needs a credit
                ops.append(Wait(("credit", (a + 1) % 2, 0), 1))
            ops.append(DmaStart(a, 0))            # forward the block
        ops.append(Accum(a, 0))                   # fold it
        if a <= P - 2:
            ops.append(Wait(("send", (a + 1) % 2, 0), 1))  # forward left
        if a + 2 <= P - 1:                        # slot reused at a+2
            ops.append(Signal(left, ("credit", slot, 0)))
    ops += [Signal(left, ("bar",)), Signal(right, ("bar",)),
            Wait(("bar",), 2)]
    return ops


class AttentionSim(RingSim):
    """RingSim specialization for the K/V circulation protocol: payloads
    are block ids moving through the 2-slot landing buffer; ``out`` is
    reused as the per-device fold log (which blocks were folded, in what
    order).  Invariants: the shared 1-4 (no deadlock, no slot overwrite,
    no read-while-landing, sems drain) plus (5') every device folds
    every block EXACTLY once, in ring order my, my-1, ..., my-P+1.

    ``hq``/``hkv`` model the multi-head/GQA payload layout (executed
    checks, not relabeling arguments): the payload
    carries one (plane, block) entry per K and V head-plane, and the
    fold validates that EVERY plane of exactly one block is present —
    a send that split or mixed head planes across RDMAs would be
    caught.  ``causal=True`` models the fold-skip: arrivals with
    kv_idx > my leave the fold log untouched (the protocol events are
    identical — the kernel's pl.when gates only the MXU body), and the
    final check expects exactly the non-future blocks."""

    def __init__(self, P: int, hq: int = 1, hkv: int = 1,
                 causal: bool = False):
        # reuse RingSim's machinery with a 1-flow ALLGATHER-ish config;
        # programs/payloads are overridden below
        super().__init__(P, 1, rot=0, allgather=True, rs=False,
                         track_data=True,
                         program_override=lambda d, p, k, **kw:
                         attention_program(d, p))
        # fold log replaces the out grid; comm keeps (state, payload)
        self.folded: List[List[int]] = [[] for _ in range(P)]
        # what each device's NEXT send actually carries is read from the
        # slot at DmaStart time (catching schedule bugs for real)
        self.own_block = list(range(P))
        self.hq, self.hkv, self.causal = hq, hkv, causal
        self.planes = tuple([("k", h) for h in range(hkv)]
                            + [("v", h) for h in range(hkv)])

    def _block_of(self, payload, d: int, where: str) -> int:
        """The single block id a complete payload carries — every K and
        V head-plane present, all naming the same block."""
        blocks = {b for (_, b) in payload}
        planes = {p for (p, _) in payload}
        if len(blocks) != 1 or planes != set(self.planes):
            raise ProtocolViolation(
                f"dev{d} {where}: payload {sorted(payload)} is not ONE "
                f"block with all {len(self.planes)} head planes")
        return next(iter(blocks))

    def _mk_dma(self, d: int, u: int, fi: int) -> Dma:
        P = self.P
        if u == 0:
            payload = frozenset((pl, d) for pl in self.planes)
        else:
            state, payload = self.comm[d][(u % 2, 0)]
            if state != "full":
                raise ProtocolViolation(
                    f"dev{d} forwarded from EMPTY slot {(u % 2, 0)} at "
                    f"send {u} (forward started before arrival consumed)")
        return Dma(d, u, fi, "started", payload, (u % 2, fi), (d + 1) % P,
                   dst_slot=((u + 1) % 2, fi), dst_region=None)

    def step(self, event: Tuple) -> None:
        kind = event[0]
        if kind == "dev":
            d = event[1]
            op = self.progs[d][self.pc[d]]
            if isinstance(op, Signal) and op.sem[0] == "credit":
                # crediting left = promising MY slot is reusable; free it
                # (its content was folded AND forwarded out — the program
                # places the signal after Accum and wait_send)
                self.comm[d][(op.sem[1], op.sem[2])] = ("empty", frozenset())
            super().step(event)
            return
        if kind == "leave":
            # a forward (u>0) reads a comm SLOT; verify it never changed
            # under the in-flight read (RingSim's leave checks the out
            # grid instead, which attention does not use)
            dma = self.dmas[event[1]]
            if dma.u > 0:
                state, cur = self.comm[dma.src][dma.src_region]
                if state != "full" or cur != dma.payload:
                    raise ProtocolViolation(
                        f"slot {dma.src_region} of dev{dma.src} changed "
                        f"while forward u={dma.u} was reading it "
                        f"(invariant 3)")
            dma.phase = "left"
            sk = ("send", (dma.u + 1) % 2, dma.seg)
            self.sems[dma.src][sk] = self.sems[dma.src].get(sk, 0) + 1
            self._record_occupancy()
            return
        # arrive: attention's recv semaphores are indexed by the LANDING
        # slot parity (u+1)%2, not RingSim's u%2 — handle fully here
        i = event[1]
        dma = self.dmas[i]
        dst = dma.dst
        state, _ = self.comm[dst][dma.dst_slot]
        if state == "full":
            raise ProtocolViolation(
                f"arrival u={dma.u} from dev{dma.src} overwrote unconsumed "
                f"slot {dma.dst_slot} on dev{dst} (invariant 2)")
        for other in self.dmas:
            if (other is not dma and other.phase == "started"
                    and other.src == dst and other.u > 0
                    and other.src_region == dma.dst_slot):
                raise ProtocolViolation(
                    f"arrival u={dma.u} landed in slot {dma.dst_slot} of "
                    f"dev{dst} while dev{dst}'s forward u={other.u} was "
                    f"reading it (invariant 3)")
        self.comm[dst][dma.dst_slot] = ("full", dma.payload)
        rk = ("recv", dma.dst_slot[0], dma.seg)
        self.sems[dst][rk] = self.sems[dst].get(rk, 0) + 1
        del self.dmas[i]
        self._record_occupancy()

    def _accum(self, d: int, u: int, seg: int) -> None:
        if u == 0:
            self.folded[d].append(d)              # own block, no slot
            return
        slot = (u % 2, seg)
        state, payload = self.comm[d][slot]
        if state != "full":
            raise ProtocolViolation(
                f"dev{d} folded EMPTY slot {slot} at arrival {u}")
        b = self._block_of(payload, d, f"arrival {u}")
        if not self.causal or b <= d:
            self.folded[d].append(b)  # causal skips future blocks' MXU
        # the slot stays FULL until the credit signal frees it (it is
        # still the forward's RDMA source); never-credited tail slots
        # simply stay full to exit — no invariant needs them empty

    def check_final(self) -> None:
        for d in range(self.P):
            for k, vv in self.sems[d].items():
                if vv != 0:
                    raise ProtocolViolation(
                        f"semaphore {k} on dev{d} = {vv} at exit "
                        f"(invariant 4)")
            want = [(d - a) % self.P for a in range(self.P)]
            if self.causal:
                want = [b for b in want if b <= d]
            if self.folded[d] != want:
                raise ProtocolViolation(
                    f"dev{d} folded {self.folded[d]}, want ring order "
                    f"{want} (invariant 5')")


def _explore(fresh, max_states: int) -> int:
    """Shared exhaustive DFS over every interleaving (protocol state, no
    payload tracking): every reachable state must have an enabled event
    unless the run is complete, and every terminal state must pass
    ``check_final``.  Returns the number of distinct states visited."""
    seen = set()
    root = fresh()
    stack = [[]]  # paths (event lists); replay is cheap at these sizes
    seen.add(root._snapshot())
    visited = 1
    while stack:
        path = stack.pop()
        sim = fresh()
        for e in path:
            sim.step(e)
        if sim.done():
            sim.check_final()
            continue
        ev = sim.enabled_events()
        if not ev:
            raise ProtocolViolation(
                f"DEADLOCK at depth {len(path)}: pc={sim.pc} "
                f"dmas={[(d.src, d.u, d.seg, d.phase) for d in sim.dmas]}")
        for e in ev:
            child = fresh()
            for pe in path:
                child.step(pe)
            child.step(e)
            snap = child._snapshot()
            if snap in seen:
                continue
            seen.add(snap)
            visited += 1
            if visited > max_states:
                raise ProtocolViolation("state space larger than budget")
            stack.append(path + [e])
    return visited


def explore_attention(P: int, max_states: int = 2_000_000,
                      hq: int = 1, hkv: int = 1,
                      causal: bool = False) -> int:
    """Exhaustive DFS over the attention circulation protocol (the
    ``explore_all`` twin for AttentionSim)."""
    return _explore(lambda: AttentionSim(P, hq, hkv, causal), max_states)


# ---------------------------------------------------------------------------
# Ring-attention BACKWARD circulation (pallas_attention._bwd_kernel)
# ---------------------------------------------------------------------------


def attention_bwd_program(my: int, P: int) -> List[object]:
    """The pipelined ``pallas_attention._bwd_kernel`` body for device
    ``my`` as a static op list.  [K, V, dK, dV] circulate for a FULL
    cycle: sends 0..P-1, arrivals 1..P; arrival P is the home arrival
    (my own block back, all ranks' dK/dV accumulated), consumed without
    forwarding.  Fold-BEFORE-forward: ``Accum(a)`` both consumes and
    MUTATES slot a%2 (adds this rank's dK/dV contribution), then
    ``DmaStart(a)`` forwards the mutated payload.  Ordering invariant
    (an earlier ordering deadlocked at P>=3): the
    retire of hop a-1 (wait_send) and its credit signal come BEFORE
    hop a's credit wait, so every signal precedes, in program order,
    the waits it transitively feeds around the ring."""
    left, right = (my - 1) % P, (my + 1) % P
    ops: List[object] = [Accum(0, 0)]             # fold own block +
    #                                               assemble [K,V,dK,dV]
    ops += [Signal(left, ("bar",)), Signal(right, ("bar",)),
            Wait(("bar",), 2)]
    if P >= 2:
        ops.append(DmaStart(0, 0))                # circulate own block
    for a in range(1, P + 1):
        slot = a % 2
        ops.append(Wait(("recv", slot, 0), 1))    # arrival a landed
        if a < P:
            ops.append(Accum(a, 0))               # fold + mutate slot
            # retire snd(a-1) (its send sem parity = ((a-1)+1)%2), then
            # credit its source slot — BEFORE this hop's credit wait
            ops.append(Wait(("send", slot, 0), 1))
            if 1 <= a - 1 <= P - 2:
                ops.append(Signal(left, ("credit", (a - 1) % 2, 0)))
            if a >= 2:
                ops.append(Wait(("credit", (a + 1) % 2, 0), 1))
            ops.append(DmaStart(a, 0))            # forward mutated block
        else:
            ops.append(Wait(("send", slot, 0), 1))  # retire snd(P-1)
            ops.append(Accum(a, 0))               # consume home arrival
    ops += [Signal(left, ("bar",)), Signal(right, ("bar",)),
            Wait(("bar",), 2)]
    return ops


class AttentionBwdSim(AttentionSim):
    """The backward circulation's model: payloads are
    {(plane, block)} ∪ {("g", rank)} — the [K,V,dK,dV] head planes plus
    the set of ranks whose dK/dV contribution has been folded in.
    Invariants: the shared 1-4, plus

    5b. fold-before-forward: a forwarded payload ALWAYS contains the
        forwarding rank's own contribution (checked at DmaStart);
    5c. every device folds every block once in ring order (causal:
        the non-future blocks), mutating the slot payload;
    5d. the home arrival returns this device's OWN block carrying the
        contribution of EVERY rank (causal: every rank >= the block
        id) — the accumulators really made the full cycle."""

    def __init__(self, P: int, hq: int = 1, hkv: int = 1,
                 causal: bool = False):
        RingSim.__init__(self, P, 1, rot=0, allgather=True, rs=False,
                         track_data=True,
                         program_override=lambda d, p, k, **kw:
                         attention_bwd_program(d, p))
        self.folded = [[] for _ in range(P)]
        self.own_block = list(range(P))
        self.hq, self.hkv, self.causal = hq, hkv, causal
        self.planes = tuple([(pl, h) for pl in ("k", "v", "dk", "dv")
                             for h in range(hkv)])
        self.home: List[Optional[FrozenSet]] = [None] * P

    @staticmethod
    def _split(payload):
        return ({e for e in payload if e[0] != "g"},
                {e for e in payload if e[0] == "g"})

    def _block_of(self, payload, d: int, where: str) -> int:
        kv, _ = self._split(payload)
        blocks = {b for (_, b) in kv}
        planes = {p for (p, _) in kv}
        if len(blocks) != 1 or planes != set(self.planes):
            raise ProtocolViolation(
                f"dev{d} {where}: payload {sorted(kv)} is not ONE block "
                f"with all {len(self.planes)} planes")
        return next(iter(blocks))

    def _mk_dma(self, d: int, u: int, fi: int) -> Dma:
        P = self.P
        if u == 0:
            payload = frozenset({(pl, d) for pl in self.planes}
                                | {("g", d)})
        else:
            state, payload = self.comm[d][(u % 2, 0)]
            if state != "full":
                raise ProtocolViolation(
                    f"dev{d} forwarded from EMPTY slot {(u % 2, 0)} at "
                    f"send {u} (forward started before arrival consumed)")
            b = self._block_of(payload, d, f"send {u}")
            _, grads = self._split(payload)
            if (not self.causal or b <= d) and ("g", d) not in grads:
                raise ProtocolViolation(
                    f"dev{d} send {u} forwarded block {b} WITHOUT its own "
                    f"dK/dV contribution (fold-before-forward, "
                    f"invariant 5b): grads={sorted(grads)}")
        return Dma(d, u, fi, "started", payload, (u % 2, fi), (d + 1) % P,
                   dst_slot=((u + 1) % 2, fi), dst_region=None)

    def _accum(self, d: int, u: int, seg: int) -> None:
        P = self.P
        if u == 0:
            self.folded[d].append(d)  # own block (payload built at send)
            return
        slot = (u % 2, seg)
        state, payload = self.comm[d][slot]
        if state != "full":
            raise ProtocolViolation(
                f"dev{d} folded EMPTY slot {slot} at arrival {u}")
        b = self._block_of(payload, d, f"arrival {u}")
        if u == P:
            # home arrival: my block, everyone's contribution aboard
            _, grads = self._split(payload)
            if b != d:
                raise ProtocolViolation(
                    f"dev{d} home arrival carries block {b}, want {d} "
                    f"(invariant 5d)")
            want = {("g", r) for r in range(P)
                    if not self.causal or d <= r}
            if grads != want:
                raise ProtocolViolation(
                    f"dev{d} home arrival grads {sorted(grads)}, want "
                    f"{sorted(want)} (invariant 5d)")
            self.home[d] = payload
            return
        if not self.causal or b <= d:
            self.folded[d].append(b)
            # the fold MUTATES the slot: my contribution rides along
            self.comm[d][slot] = ("full", payload | {("g", d)})

    def check_final(self) -> None:
        super().check_final()  # sems drain + fold-log ring order (5c)
        for d in range(self.P):
            if self.home[d] is None:
                raise ProtocolViolation(
                    f"dev{d} never consumed its home arrival "
                    f"(invariant 5d)")


def explore_attention_bwd(P: int, max_states: int = 2_000_000,
                          hq: int = 1, hkv: int = 1,
                          causal: bool = False) -> int:
    """Exhaustive DFS over the backward circulation protocol."""
    return _explore(lambda: AttentionBwdSim(P, hq, hkv, causal),
                    max_states)


def explore_all(P: int, K: int, *, rot: int, allgather: bool,
                rs: bool = True,
                dirs: Optional[Tuple[int, ...]] = None,
                max_states: int = 2_000_000) -> int:
    """Exhaustive DFS over the collective-ring protocol (see
    ``_explore`` for the search contract)."""
    return _explore(
        lambda: RingSim(P, K, rot=rot, allgather=allgather, rs=rs,
                        track_data=False, dirs=dirs), max_states)
