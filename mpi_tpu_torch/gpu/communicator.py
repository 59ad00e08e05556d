"""TorchCommunicator — MPI semantics over P virtual ranks on one device.

Counterpart of ``mpi_tpu/tpu/communicator.py``.  A rank is an index on the
leading dimension that ``run_spmd`` maps ``torch.vmap`` over, not a
process.  Methods are called inside the per-rank program; ``rank`` is a
batched integer tensor there and ``size`` a Python int.

Collectives keep the reference's ``algorithm=`` names so user programs run
unchanged: ``'fused'`` is plain torch over the rank dimension (XLA computed
it outside any kernel); ``'ring'``, ``'recursive_halving'``, ``'tree'``,
``'doubling'`` and ``'pairwise'`` are the hand schedules of
``gpu/collectives.py``; ``'pallas_ring'`` is the CUDA ring kernel of
``gpu/ring.py``.

``split`` produces equal-sized groups (one independent sub-world per
group).  The SPMD restrictions carry over with the reference's diagnoses:
per-rank ``send``/``recv``/``isend``/``probe`` raise ``SpmdSemanticsError``
and unequal groups raise ``ValueError``.
"""

from __future__ import annotations

import warnings
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from .. import ops as _ops
from .. import schedules
from ..checker import validate_perm
from ..communicator import Communicator, _CompletedRequest
from . import collectives as algos
from . import primitives
from . import ring
from .window import TorchWindow

Pair = Tuple[int, int]


def _pallas_op_name(op: _ops.ReduceOp) -> str:
    """The ring kernel's combiner, gated by object IDENTITY against the
    built-ins (a user ``make_op`` named 'max' is never swapped for
    torch.maximum)."""
    for builtin in (_ops.SUM, _ops.MAX, _ops.MIN):
        if op is builtin:
            return op.name
    raise NotImplementedError(
        f"pallas_ring supports the built-in SUM/MAX/MIN ops, got {op!r}; "
        f"use a ppermute algorithm ('ring'/'recursive_halving') for other "
        f"reductions")


class SpmdSemanticsError(NotImplementedError):
    """An MPI idiom with no SPMD analogue was used on the SPMD backend."""


def _unsupported(what: str, alternative: str):
    return SpmdSemanticsError(
        f"{what} has no per-rank analogue inside one SPMD program: every "
        f"rank executes the same program, so rank-dependent message "
        f"initiation cannot be expressed. {alternative}")


_P2P_HINT = ("Use comm.shift(x, offset) for neighbor patterns, "
             "comm.exchange(x, pairs) for an arbitrary static pattern, or a "
             "collective.")


class TorchCommunicator(Communicator):
    """MPI communicator over ``nranks`` virtual ranks.

    ``groups=None`` covers every rank (MPI_COMM_WORLD).  After a split,
    ``groups`` partitions the ranks into equal-sized groups and every
    method operates group-locally."""

    # replicated gathers above this many bytes per rank warn (the
    # reference's ``gather_replicated_warn_bytes`` mpit cvar default)
    gather_replicated_warn_bytes = 64 << 20

    def __init__(self, nranks: int, groups: Optional[List[List[int]]] = None):
        if nranks < 1:
            raise ValueError(f"need at least one rank, got {nranks}")
        self._axis_size = int(nranks)
        if groups is not None:
            groups = [[int(w) for w in g] for g in groups]
            sizes = {len(g) for g in groups}
            if len(sizes) != 1:
                raise ValueError(
                    f"SPMD sub-communicators must be equal-sized, got group sizes "
                    f"{sorted(len(g) for g in groups)}; pad your split colors "
                    f"(the SPMD world needs a uniform partition)")
            covered = sorted(i for g in groups for i in g)
            if covered != list(range(self._axis_size)):
                raise ValueError(
                    f"groups must partition the whole world 0..{self._axis_size - 1} "
                    f"exactly once (every rank executes the SPMD program); got {groups}")
        self._groups = groups
        rank_of = list(range(self._axis_size))
        group_of = [0] * self._axis_size
        for gi, g in enumerate(groups or []):
            for pos, world in enumerate(g):
                rank_of[world] = pos
                group_of[world] = gi
        self._rank_table = rank_of
        self._group_table = group_of

    @classmethod
    def from_groups(cls, groups: Sequence[Sequence[int]]) -> "TorchCommunicator":
        """The split communicator whose groups are ``groups`` (lists of
        world ranks, in group-rank order) — the same lists a
        ``TpuCommunicator`` carries as ``axis_index_groups``."""
        groups = [list(g) for g in groups]
        return cls(sum(len(g) for g in groups), groups)

    # -- identity ----------------------------------------------------------

    def _world(self, what: str = "this collective"):
        return primitives.current(what, self._axis_size)

    @property
    def rank(self) -> torch.Tensor:
        """Group-local rank — a batched scalar inside ``run_spmd``."""
        idx = self._world("comm.rank").idx
        if self._groups is None:
            return idx
        return primitives.lookup(self._rank_table)

    @property
    def size(self) -> int:
        return self._axis_size if self._groups is None else len(self._groups[0])

    @property
    def group_id(self) -> torch.Tensor:
        """Which sibling group this rank belongs to (0 if unsplit)."""
        self._world("comm.group_id")
        return primitives.lookup(self._group_table)

    @property
    def device(self) -> torch.device:
        """The device the running SPMD world lives on."""
        return self._world("comm.device").device

    @property
    def axis_index_groups(self) -> Optional[List[List[int]]]:
        return self._groups

    @property
    def _flat_groups(self) -> List[int]:
        groups = self._groups or [list(range(self._axis_size))]
        return [w for g in groups for w in g]

    def _world_pairs(self, group_pairs: Sequence[Pair]) -> List[Pair]:
        """Expand group-local (src, dst) pairs to world-level pairs across
        all sibling groups; validated by the checker."""
        if self._groups is None:
            pairs = list(group_pairs)
        else:
            pairs = [(g[s], g[d]) for g in self._groups for (s, d) in group_pairs]
        validate_perm(pairs, self._axis_size)
        return pairs

    def _tensor(self, obj) -> torch.Tensor:
        self._world()
        return primitives.as_tensor(obj)

    # -- point-to-point ----------------------------------------------------

    def send(self, obj: Any, dest: int, tag: int = 0) -> None:
        raise _unsupported("MPI_Send", _P2P_HINT)

    def recv(self, source: int = -1, tag: int = -1, status=None) -> Any:
        raise _unsupported("MPI_Recv", _P2P_HINT)

    def sendrecv(self, sendobj: Any, dest: int, source: int = -1,
                 sendtag: int = 0, recvtag: int = -1, status=None) -> Any:
        raise _unsupported(
            "MPI_Sendrecv with per-rank dest/source",
            "If the pattern is a uniform ring offset use comm.shift(x, offset); "
            "if it is a fixed pattern use comm.exchange(x, pairs).")

    def isend(self, obj: Any, dest: int, tag: int = 0):
        raise _unsupported("MPI_Isend", _P2P_HINT)

    def irecv(self, source: int = -1, tag: int = -1):
        raise _unsupported("MPI_Irecv", _P2P_HINT)

    def isendrecv(self, sendobj: Any, dest: int, source: int = -1,
                  sendtag: int = 0, recvtag: int = -1):
        raise _unsupported("MPI_Isendrecv with per-rank dest/source", _P2P_HINT)

    def isendrecv_replace(self, buf, dest: int, source: int = -1,
                          sendtag: int = 0, recvtag: int = -1):
        raise _unsupported("MPI_Isendrecv_replace with per-rank dest/source",
                           _P2P_HINT)

    def send_init(self, buf: Any, dest: int, tag: int = 0):
        raise _unsupported("MPI_Send_init", _P2P_HINT)

    def recv_init(self, source: int = -1, tag: int = -1, buf: Any = None):
        raise _unsupported("MPI_Recv_init", _P2P_HINT)

    def probe(self, source: int = -1, tag: int = -1, status=None):
        raise _unsupported(
            "MPI_Probe", "SPMD message arrival is static — there is nothing "
            "to probe; restructure with shift/exchange/collectives.")

    def iprobe(self, source: int = -1, tag: int = -1, status=None):
        raise _unsupported(
            "MPI_Iprobe", "SPMD message arrival is static — there is nothing "
            "to probe; restructure with shift/exchange/collectives.")

    def shift(self, obj, offset: int = 1, wrap: bool = True, fill: Any = None):
        """Neighbor exchange as exactly one ppermute of the rank dimension."""
        if not wrap and fill is None:
            raise SpmdSemanticsError(
                "shift(wrap=False) needs an explicit numeric fill on the SPMD "
                "backend: SPMD has no 'None at the boundary' (the CPU backends "
                "return None there) — pass fill=<boundary value> so all "
                "backends agree")
        x = self._tensor(obj)
        p = self.size
        pairs = self._world_pairs(schedules.ring_perm(p, offset, wrap=wrap))
        recvd = primitives.ppermute(x, pairs)
        if not wrap:
            receivers = [r for r in range(p) if 0 <= r - offset < p]
            has_src = algos._mask_of(
                [g[r] for g in (self._groups or [list(range(p))]) for r in receivers],
                self._axis_size)
            recvd = torch.where(has_src, recvd, torch.full_like(recvd, fill))
        return recvd

    def localize(self, obj):
        """Brand a value as rank-varying over this comm's groups (the
        reference's ``localize``, ``tpu/communicator.py:274``, a
        ``pvary``): the value is unchanged; a gradient that flows back
        through it is summed over each group whose values were all equal
        (``pvary`` of an invariant value) and passes unchanged elsewhere.
        Outside a differentiated function it changes nothing: per-rank
        state wrapped once at creation keeps local gradients, as on every
        backend.  Inside one, wrap a value the same on every rank of a
        group (a reduced value, a replicated input) at each use where it
        meets rank-varying values, where JAX's typing puts its ``pvary``:
        the gradients then equal ``jax.grad``'s.  Without the mark the
        fused SUM's backward raises where its cotangents differ, and a
        replicated input's gradient is each rank's own part (see
        ``primitives._GroupReduce``)."""
        if self.size == 1:
            return obj
        self._world("localize")
        return pytree.tree_map(
            lambda x: primitives.localize(x, self._flat_groups, self.size), obj)

    def replicate(self, obj, root: int = 0):
        """Every rank takes ``root``'s value (a masked fused sum, as the
        reference brands a value-replicated result)."""
        return self.bcast(obj, root, "fused")

    def exchange(self, obj, pairs: Sequence[Pair], fill: Any = None):
        """Static-pattern p2p: every (src, dst) in ``pairs`` (group-local
        ranks) ships src's payload to dst in one ppermute; ranks not
        receiving get zeros (or ``fill``)."""
        x = self._tensor(obj)
        world = self._world_pairs(pairs)
        out = primitives.ppermute(x, world)
        if fill is not None:
            has_src = algos._mask_of([d for _, d in world], self._axis_size)
            out = torch.where(has_src, out, torch.full_like(out, fill))
        return out

    # -- nonblocking collectives: launched eagerly, returned complete ------

    def ibcast(self, obj, root: int = 0):
        return _CompletedRequest(self.bcast(obj, root))

    def ireduce(self, obj, op: _ops.ReduceOp = _ops.SUM, root: int = 0):
        return _CompletedRequest(self.reduce(obj, op, root))

    def iallreduce(self, obj, op: _ops.ReduceOp = _ops.SUM,
                   algorithm: str = "auto"):
        return _CompletedRequest(self.allreduce(obj, op, algorithm))

    def iallgather(self, obj):
        return _CompletedRequest(self.allgather(obj))

    def ialltoall(self, objs):
        return _CompletedRequest(self.alltoall(objs))

    def ibarrier(self):
        self.barrier()
        return _CompletedRequest(None)

    def iscatter(self, objs, root: int = 0):
        return _CompletedRequest(self.scatter(objs, root))

    def igather(self, obj, root: int = 0):
        return _CompletedRequest(self.gather(obj, root))

    # -- one-sided (RMA) ---------------------------------------------------

    def win_create(self, init: Any) -> TorchWindow:
        """MPI_Win_create over this communicator: fence epochs of static
        (src, dst) patterns (``gpu/window.py``)."""
        return TorchWindow(self, init)

    # -- collectives -------------------------------------------------------

    def bcast(self, obj, root: int = 0, algorithm: str = "auto"):
        x = self._tensor(obj)
        if algorithm == "auto":
            algorithm = "fused"
        if self.size == 1:
            return x
        if algorithm == "fused":
            if x.dtype == torch.bool:
                return self.bcast(x.to(torch.uint8), root, "fused").to(torch.bool)
            masked = torch.where(self.rank == root, x, torch.zeros_like(x))
            return primitives.group_reduce(masked, self._flat_groups,
                                           self.size, "sum")
        if algorithm == "tree":
            return algos.tree_bcast(x, self.size, self.rank, self._world_pairs,
                                    self._axis_size, root)
        raise ValueError(f"unknown bcast algorithm {algorithm!r}")

    def reduce(self, obj, op: _ops.ReduceOp = _ops.SUM, root: int = 0,
               algorithm: str = "auto"):
        """Root holds the reduction; all other ranks hold the op identity."""
        x = self._tensor(obj)
        if algorithm == "auto":
            algorithm = "tree"
        if self.size == 1:
            return x
        if algorithm == "fused":
            full = self.allreduce(x, op, algorithm="fused")
            ident = torch.full(x.shape, op.identity(x.dtype), dtype=x.dtype,
                               device=x.device)
            return torch.where(self.rank == root, full, ident)
        if algorithm == "tree":
            return algos.tree_reduce(x, self.size, self.rank, self._world_pairs,
                                     self._axis_size, op, root)
        raise ValueError(f"unknown reduce algorithm {algorithm!r}")

    def allreduce(self, obj, op: _ops.ReduceOp = _ops.SUM, algorithm: str = "auto"):
        """``algorithm='auto'`` resolves to 'fused', as in the reference."""
        x = self._tensor(obj)
        if algorithm == "auto":
            algorithm = "fused"
        if self.size == 1:
            return x
        if algorithm == "fused":
            return self._fused_allreduce(x, op)
        if algorithm == "ring":
            return algos.ring_allreduce(x, self.size, self.rank,
                                        self._world_pairs, op)
        if algorithm == "pallas_ring":
            return ring.ring_allreduce(x, self.size, groups=self._groups,
                                       op=_pallas_op_name(op))
        if algorithm == "recursive_halving":
            return algos.halving_allreduce(x, self.size, self.rank,
                                           self._world_pairs, op)
        if algorithm == "reduce_bcast":
            return self.bcast(self.reduce(x, op, 0, "tree"), 0, "tree")
        raise ValueError(f"unknown allreduce algorithm {algorithm!r}")

    def _fused_allreduce(self, x, op: _ops.ReduceOp):
        if (op.name == "sum" and x.dtype != torch.bool) or \
                op.name in ("max", "min"):
            return primitives.group_reduce(x, self._flat_groups, self.size,
                                           op.name)
        return algos.tree_reduce_local(op, self._fused_allgather(x))

    def _fused_allgather(self, x):
        return primitives.all_gather(x, self._flat_groups, self.size)

    def allgather(self, obj, algorithm: str = "auto"):
        """The stacked [size, ...] tensor in group-rank order."""
        x = self._tensor(obj)
        if algorithm == "auto":
            algorithm = "fused"
        if algorithm == "fused":
            return self._fused_allgather(x)
        if algorithm == "ring":
            return algos.ring_allgather(x, self.size, self.rank, self._world_pairs)
        if algorithm == "doubling":
            return algos.doubling_allgather(x, self.size, self.rank,
                                            self._world_pairs)
        if algorithm == "pallas_ring":
            return ring.ring_allgather(x, self.size, groups=self._groups)
        raise ValueError(f"unknown allgather algorithm {algorithm!r}")

    def alltoall(self, objs, algorithm: str = "auto"):
        """``objs``: stacked [size, ...], block i destined for group rank i;
        returns [size, ...] with block j received from rank j."""
        x = self._tensor(objs)
        if x.shape[0] != self.size:
            raise ValueError(
                f"alltoall payload needs leading dim == communicator size "
                f"({self.size}), got {tuple(x.shape)}")
        if algorithm == "auto":
            algorithm = "fused"
        if self.size == 1:
            return x
        if algorithm == "fused":
            return primitives.all_to_all(x, self._flat_groups, self.size)
        if algorithm == "pairwise":
            return algos.pairwise_alltoall(x, self.size, self.rank,
                                           self._world_pairs)
        raise ValueError(f"unknown alltoall algorithm {algorithm!r}")

    def barrier(self) -> None:
        """All ranks of one SPMD program run on one device stream, in
        program order: there is nothing to wait for."""
        self._world("barrier")

    def scan(self, obj, op: _ops.ReduceOp = _ops.SUM):
        """Hillis-Steele inclusive prefix reduction: log2(P) masked
        ppermute rounds with identity-filled holes."""
        x = self._tensor(obj)
        if self.size == 1:
            return x
        acc = x
        ident = op.identity(x.dtype)
        d = 1
        while d < self.size:
            recvd = self.shift(acc, offset=d, wrap=False, fill=ident)
            acc = op.combine(recvd, acc)  # received prefix goes LEFT
            d *= 2
        return acc

    def _allreduce_loc(self, obj, op: _ops.ReduceOp):
        x = self._tensor(obj)
        best = self.allreduce(x, op=op)
        cand = torch.where(x == best, self.rank, self.size).to(torch.int32)
        return best, self.allreduce(cand, op=_ops.MIN)

    def reduce_scatter(self, blocks, op: _ops.ReduceOp = _ops.SUM,
                       algorithm: str = "auto"):
        """``blocks``: stacked [size, ...]; returns this rank's reduced block."""
        x = self._tensor(blocks)
        if x.shape[0] != self.size:
            raise ValueError(
                f"reduce_scatter payload needs leading dim == communicator "
                f"size ({self.size}), got {tuple(x.shape)}")
        if algorithm == "auto":
            algorithm = "fused"
        if self.size == 1:
            return x[0]
        if algorithm == "fused":
            return algos.tree_reduce_local(op, self.alltoall(x, "fused"))
        if algorithm == "ring":
            return algos.ring_reduce_scatter(x, self.size, self.rank,
                                             self._world_pairs, op)
        if algorithm == "pallas_ring":
            return ring.ring_reduce_scatter(x, self.size, groups=self._groups,
                                            op=_pallas_op_name(op))
        raise ValueError(f"unknown reduce_scatter algorithm {algorithm!r}")

    def scatter(self, objs, root: int = 0):
        """``objs``: stacked [size, ...] meaningful at root; every rank gets
        block ``rank`` (a masked reduce-scatter)."""
        x = self._tensor(objs)
        if x.shape[0] != self.size:
            raise ValueError(
                f"scatter payload needs leading dim == communicator size "
                f"({self.size}), got {tuple(x.shape)}")
        if x.dtype == torch.bool:
            return self.scatter(x.to(torch.uint8), root).to(torch.bool)
        masked = torch.where(self.rank == root, x, torch.zeros_like(x))
        return self.reduce_scatter(masked, op=_ops.SUM, algorithm="fused")

    def _warn_replicated_gather(self, x, what: str) -> None:
        nbytes = x.numel() * x.element_size() * self.size
        if nbytes > self.gather_replicated_warn_bytes:
            warnings.warn(
                f"{what}: the replicated [size={self.size}, ...] stack is "
                f"{nbytes / 2**20:.0f} MiB PER RANK.  Use comm.{what}(..., "
                f"sharded=True) to keep each rank's share O(payload), or "
                f"raise TorchCommunicator.gather_replicated_warn_bytes.",
                RuntimeWarning, stacklevel=3)

    def gather(self, obj, root: int = 0, sharded: bool = False):
        """Stacked [size, ...] on every rank; ``sharded=True`` returns only
        this rank's [1, ...] slice (the stacked result of ``run_spmd`` then
        IS the gathered stack, with no communication)."""
        x = self._tensor(obj)
        if sharded:
            return x[None]
        self._warn_replicated_gather(x, "gather")
        return self.allgather(x)

    # -- vector (variable-count) collectives: static counts, padded payloads

    def allgatherv(self, obj, counts: Sequence[int]):
        """Padded input [max(counts), ...]; returns the exact ragged
        concatenation [sum(counts), ...] on every rank."""
        self._check_counts(counts)
        counts = [int(c) for c in counts]
        x = self._tensor(obj)
        maxc = max(counts) if counts else 0
        if x.shape[0] < maxc:
            raise ValueError(
                f"allgatherv payload must be padded to max(counts)={maxc} "
                f"rows (got {x.shape[0]}); SPMD shapes are static")
        g = self.allgather(x[:maxc], algorithm="fused")
        return torch.cat([g[i, : counts[i]] for i in range(self.size)], dim=0)

    def gatherv(self, obj, counts: Sequence[int], root: int = 0,
                sharded: bool = False):
        """Every rank gets the concatenation; ``sharded=True`` returns this
        rank's own block zero-padded to [max(counts), ...] (finish with
        ``ragged_concat`` on the stacked result)."""
        if sharded:
            self._check_counts(counts)
            counts = [int(c) for c in counts]
            x = self._tensor(obj)
            maxc = max(counts) if counts else 0
            if x.shape[0] < maxc:
                raise ValueError(
                    f"gatherv payload must be padded to max(counts)={maxc} "
                    f"rows (got {x.shape[0]}); SPMD shapes are static")
            x = x[:maxc]
            cnt = torch.as_tensor(counts, device=x.device)[self.rank]
            mask = torch.arange(maxc, device=x.device) < cnt
            return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                               torch.zeros_like(x))
        x = self._tensor(obj)
        self._warn_replicated_gather(x, "gatherv")
        return self.allgatherv(x, counts)

    @staticmethod
    def ragged_concat(stack, counts: Sequence[int]) -> torch.Tensor:
        """Host-side finisher for ``gatherv(..., sharded=True)``: the exact
        ragged concatenation of the [size, max(counts), ...] stack."""
        counts = [int(c) for c in counts]
        arr = torch.as_tensor(stack)
        maxc = max(counts) if counts else 0
        if arr.dim() >= 2 and arr.shape[0] == len(counts) and arr.shape[1] == maxc:
            blocks = arr
        else:
            blocks = arr.reshape((len(counts), maxc) + tuple(arr.shape[1:]))
        return torch.cat([blocks[i, : counts[i]] for i in range(len(counts))], dim=0)

    def scatterv(self, obj, counts: Sequence[int], root: int = 0):
        """Root's [sum(counts), ...] concatenation; every rank gets its
        slice padded to [max(counts), ...] with zeros."""
        self._check_counts(counts)
        counts = [int(c) for c in counts]
        x = self._tensor(obj)
        total, maxc = sum(counts), (max(counts) if counts else 0)
        if x.shape[0] != total:
            raise ValueError(
                f"scatterv payload needs sum(counts)={total} rows, got {x.shape[0]}")
        if maxc == 0:
            return x[:0]
        blocks = self.bcast(x, root)
        pad = blocks.new_zeros((maxc,) + tuple(blocks.shape[1:]))
        padded = torch.cat([blocks, pad], dim=0)
        starts = [0]
        for c in counts[:-1]:
            starts.append(starts[-1] + c)
        start = torch.as_tensor(starts, device=x.device)[self.rank]
        sliced = padded[start + torch.arange(maxc, device=x.device)]
        cnt = torch.as_tensor(counts, device=x.device)[self.rank]
        mask = torch.arange(maxc, device=x.device) < cnt
        return torch.where(mask.reshape((-1,) + (1,) * (sliced.dim() - 1)),
                           sliced, torch.zeros_like(sliced))

    def alltoallv(self, blocks, counts: Sequence[Sequence[int]]):
        """``blocks``: [size, maxc, ...] padded; returns [size, maxc, ...]
        where block j has ``counts[j][rank]`` valid rows, the rest zero."""
        self._check_counts_matrix(counts)
        cmat = [[int(c) for c in row] for row in counts]
        x = self._tensor(blocks)
        maxc = max((c for row in cmat for c in row), default=0)
        if x.shape[0] != self.size or (maxc and x.shape[1] < maxc):
            raise ValueError(
                f"alltoallv payload needs shape [size={self.size}, "
                f">=max(counts)={maxc}, ...], got {tuple(x.shape)}")
        x = x[:, :maxc]
        cnt_row = torch.as_tensor(cmat, device=x.device)[self.rank]  # [size]
        mask = torch.arange(maxc, device=x.device)[None, :] < cnt_row[:, None]
        x = torch.where(mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2)),
                        x, torch.zeros_like(x))
        return self.alltoall(x, algorithm="fused")

    # -- communicator management (host-side, outside the SPMD call) --------

    def split(self, color, key: int = 0):
        raise _unsupported(
            "comm.split(color, key) with per-rank color values",
            "Colors must be known for every rank on the host: call "
            "comm.split_all(colors, keys) with one color per world rank, or "
            "comm.split_by(lambda world_idx: color) — outside the SPMD call.")

    def split_all(self, colors: Sequence[Optional[int]],
                  keys: Optional[Sequence[int]] = None) -> "TorchCommunicator":
        """MPI_Comm_split with the full color/key vectors (host-side); each
        current group partitions by color, ordered by (key, group rank);
        the resulting groups must be equal-sized."""
        if len(colors) != self._axis_size:
            raise ValueError(
                f"need one color per world rank ({self._axis_size}), "
                f"got {len(colors)}")
        if any(c is None for c in colors):
            raise ValueError(
                "color=None (MPI_UNDEFINED) is not expressible in SPMD: every "
                "rank executes the program; give every rank a color")
        keys = list(keys) if keys is not None else [0] * self._axis_size
        parent_groups = self._groups or [list(range(self._axis_size))]
        new_groups: List[List[int]] = []
        for g in parent_groups:
            buckets: dict = {}
            for pos, world in enumerate(g):
                buckets.setdefault(colors[world], []).append((keys[world], pos, world))
            for c in sorted(buckets):
                new_groups.append([w for _, _, w in sorted(buckets[c])])
        return TorchCommunicator(self._axis_size, new_groups)

    def split_by(self, color_fn, key_fn=None) -> "TorchCommunicator":
        """split_all with functions of the world rank."""
        n = self._axis_size
        return self.split_all([color_fn(i) for i in range(n)],
                              [key_fn(i) for i in range(n)] if key_fn else None)

    def split_type(self, split_type: str = "shared",
                   key: int = 0) -> "TorchCommunicator":
        """MPI_Comm_split_type(COMM_TYPE_SHARED): every virtual rank shares
        the one device's memory, so the split is the whole communicator."""
        if split_type != "shared":
            raise ValueError(f"unknown split_type {split_type!r}")
        return self.split_by(lambda i: 0)

    def split_by_rank(self, color_fn, key_fn=None) -> "TorchCommunicator":
        """``split`` with color/key as functions of the group-local rank."""
        local = [self._rank_table[w] for w in range(self._axis_size)]
        return self.split_all([color_fn(r) for r in local],
                              [key_fn(r) for r in local] if key_fn else None)

    def create(self, group) -> "TorchCommunicator":
        """MPI_Comm_create_group, SPMD shape: the complement ranks form
        sibling communicators of the member size; anything else raises."""
        self._check_group(group)
        ranks = list(group.ranks)
        members = set(ranks)
        others = [r for r in range(self.size) if r not in members]
        if others and len(others) % len(ranks) != 0:
            raise SpmdSemanticsError(
                f"create(group) needs the non-member count ({len(others)}) to "
                f"split into groups of the member size ({len(ranks)}): every "
                f"rank executes the SPMD program, so the complement must "
                f"form equal-sized sibling communicators")

        def color(r: int) -> int:
            return 0 if r in members else 1 + others.index(r) // len(ranks)

        def key(r: int) -> int:
            return ranks.index(r) if r in members else others.index(r) % len(ranks)

        return self.split_by_rank(color, key)

    def dup(self) -> "TorchCommunicator":
        return TorchCommunicator(self._axis_size, self._groups)

    def free(self) -> None:
        pass
