"""Intercommunicators — two-group MPI communication [S: MPI_Intercomm_*].

The port's own copy of ``mpi_tpu/intercomm.py`` (:1-225): the same
construction, tags and result conventions, with tensor payloads that stay
on their device (the inter-allreduce folds the remote group's tensors with
the op's ``combine`` in remote rank order, as the reference folds numpy
arrays).

An intercommunicator binds a LOCAL group and a REMOTE group: point-to-point
ranks address the remote group, and collectives exchange between the groups
(MPI's rooted "MPI_ROOT / MPI_PROC_NULL" convention).  The classic use is
coupling two independently-sized programs — e.g. an ocean model feeding an
atmosphere model, or a producer pool feeding a consumer pool.

Construction here is the host-side spelling consistent with the rest of the
framework (``split_all`` philosophy): every rank names BOTH groups
explicitly, so no leader/bridge negotiation is needed and the same call is
meaningful for an SPMD program's host setup.  MPI's leader-based
``MPI_Intercomm_create(local_comm, local_leader, bridge, remote_leader,
tag)`` is a wire protocol for discovering exactly this information; with a
global view it collapses to the explicit form.

Process backends only: rank-dynamic cross-group p2p is the designed home of
the CPU transports.  On the SPMD backend (``TorchCommunicator``), express
two-group patterns as a split plus ``exchange``/grouped collectives (the
diagnostics point there).

Internals: one child communicator over the UNION of the groups (fresh
context from the parent, so intercomm traffic can never match intracomm
traffic), plus the two orderings.  Collective semantics are implemented on
top of union-group primitives.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from .communicator import Communicator, P2PCommunicator, Status

# Rooted-collective sentinels [S]: on the root's SIDE, the one root rank
# passes ROOT and its peers pass PROC_NULL; the opposite group passes the
# root's rank within that opposite (remote-to-them) group.
ROOT = -3
PROC_NULL = -2


class InterComm:
    """Two-group communicator; see module docstring.

    ``rank``/``size`` describe the LOCAL group, ``remote_size`` the other
    side; p2p ``dest``/``source`` are REMOTE-group ranks [S]."""

    def __init__(self, union_comm: P2PCommunicator,
                 local_pos: Sequence[int], remote_pos: Sequence[int]):
        self._u = union_comm
        self._local = list(local_pos)    # union-rank of each local member
        self._remote = list(remote_pos)  # union-rank of each remote member
        self._rank = self._local.index(union_comm.rank)

    # -- identity ----------------------------------------------------------

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return len(self._local)

    @property
    def remote_size(self) -> int:
        """MPI_Comm_remote_size [S]."""
        return len(self._remote)

    @property
    def is_inter(self) -> bool:
        """MPI_Comm_test_inter [S]."""
        return True

    # -- point-to-point (remote-group addressing) --------------------------

    def _remote_union(self, r: int) -> int:
        if not (0 <= r < len(self._remote)):
            raise ValueError(
                f"remote rank {r} out of range (remote_size="
                f"{len(self._remote)})")
        return self._remote[r]

    def send(self, obj: Any, dest: int, tag: int = 0) -> None:
        self._u.send(obj, self._remote_union(dest), tag)

    def recv(self, source: int = -1, tag: int = -1,
             status: Optional[Status] = None) -> Any:
        src = -1 if source == -1 else self._remote_union(source)
        st = Status() if status is not None else None
        obj = self._u.recv(src, tag, st)
        if status is not None and st is not None:
            # st.source is a union-comm rank; report the REMOTE-group rank
            status.tag = st.tag
            status.source = self._remote.index(st.source)
            status.count_bytes = st.count_bytes
        return obj

    def isend(self, obj: Any, dest: int, tag: int = 0):
        return self._u.isend(obj, self._remote_union(dest), tag)

    def irecv(self, source: int = -1, tag: int = -1):
        src = -1 if source == -1 else self._remote_union(source)
        return self._u.irecv(src, tag)

    def sendrecv(self, sendobj: Any, dest: int, source: int = -1,
                 sendtag: int = 0, recvtag: int = -1) -> Any:
        req = self.isend(sendobj, dest, sendtag)
        out = self.recv(source, recvtag)
        req.wait()
        return out

    # -- collectives (inter-group semantics [S]) ---------------------------

    def barrier(self) -> None:
        self._u.barrier()

    def bcast(self, obj: Any, root: int):
        """Rooted: on the root's side pass ``root=ROOT`` (the root rank) or
        ``root=PROC_NULL`` (its peers, obj ignored); on the receiving side
        pass the root's REMOTE rank.  Receiving side returns the payload;
        the root's side returns ``obj`` unchanged."""
        if root == ROOT:
            for u in self._remote:
                self._u._send_internal(obj, u, _TAG_IBCAST)
            return obj
        if root == PROC_NULL:
            return obj
        return self._u._recv_internal(self._remote_union(root),
                                      _TAG_IBCAST, None)

    def allgather(self, obj: Any) -> List[Any]:
        """Each side contributes; each rank returns the REMOTE group's
        contributions in remote rank order [S]."""
        everything = self._u.allgather(obj)
        return [everything[u] for u in self._remote]

    def alltoall(self, objs: Sequence[Any]) -> List[Any]:
        """``objs[j]`` goes to remote rank j; returns one payload from each
        remote rank, in remote rank order."""
        if len(objs) != len(self._remote):
            raise ValueError(
                f"need one payload per remote rank ({len(self._remote)}), "
                f"got {len(objs)}")
        for j in range(len(self._remote)):
            self._u._send_internal(objs[j], self._remote[j], _TAG_IA2A)
        return [self._u._recv_internal(u, _TAG_IA2A, None)
                for u in self._remote]

    def allreduce(self, obj: Any, op=None):
        """MPI inter-allreduce [S]: every rank returns the reduction of the
        REMOTE group's contributions."""
        from . import ops as _ops

        op = op or _ops.SUM
        theirs = self.allgather(obj)
        acc = theirs[0]
        for v in theirs[1:]:
            acc = op.combine(acc, v)
        return acc

    # -- management --------------------------------------------------------

    def merge(self, high: bool = False) -> Communicator:
        """MPI_Intercomm_merge [S]: one intracommunicator over both groups;
        the group passing ``high=False`` gets the lower ranks.  Every rank
        of both groups calls it (collectively) with its side's flag."""
        # order key: (side_is_high, position within side), computed
        # locally and made total by split's (key, rank) ordering
        key = (1 << 20 if high else 0) + self._rank
        merged = self._u.split(0, key)
        assert merged is not None
        return merged

    def free(self) -> None:
        self._u.free()


# Internal tags: NEGATIVE, like every collective in communicator.py:
# user-level ANY_TAG never matches them (Mailbox._matches), so a wildcard
# recv can never steal a collective payload.
_TAG_IBCAST = -20
_TAG_IA2A = -21


def create_intercomm(parent: Communicator, group_a: Sequence[int],
                     group_b: Sequence[int]) -> Optional[InterComm]:
    """Collectively build an intercommunicator from two disjoint groups of
    ``parent`` (parent-comm ranks, identical arguments on every rank).
    Members of A see B as the remote group and vice versa; ranks in
    neither group get None (they still participate in the collective
    context allocation, like MPI_Comm_split with MPI_UNDEFINED)."""
    if not isinstance(parent, P2PCommunicator):
        raise NotImplementedError(
            "intercommunicators are a process-backend feature; on the SPMD "
            "backend express two-group patterns with comm.split_by + "
            "exchange/grouped collectives")
    group_a = getattr(group_a, "ranks", group_a)  # accept Group objects
    group_b = getattr(group_b, "ranks", group_b)
    a, b = [int(r) for r in group_a], [int(r) for r in group_b]
    if not a or not b:
        raise ValueError("both groups must be non-empty")
    if len(set(a)) != len(a) or len(set(b)) != len(b):
        raise ValueError(f"duplicate ranks in a group: {a} / {b}")
    if set(a) & set(b):
        raise ValueError(f"groups must be disjoint: {sorted(set(a) & set(b))}")
    for r in a + b:
        if not (0 <= r < parent.size):
            raise ValueError(f"rank {r} out of range for parent size "
                             f"{parent.size}")
    me = parent.rank
    member = me in a or me in b
    # ONE collective split call on the parent (everyone participates)
    union = a + b
    color = 0 if member else None
    key = union.index(me) if member else 0
    child = parent.split(color, key)
    if not member:
        return None
    assert child is not None
    # child rank order == union order (split sorts by (key, parent rank))
    a_pos = list(range(len(a)))
    b_pos = list(range(len(a), len(a) + len(b)))
    if me in a:
        return InterComm(child, a_pos, b_pos)
    return InterComm(child, b_pos, a_pos)
