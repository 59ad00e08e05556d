"""Process topologies — MPI_Cart_create / shift / sub and MPI graph
topologies [S].

Own copy of ``mpi_tpu/topology.py``: ``dims_create``, ``CartComm``,
``cart_create``, ``GraphComm``, ``graph_create`` (:27-417), the
hierarchical splits ``multihost_node_key``, ``split_hierarchical``,
``split_hierarchical3`` and ``HierarchicalComm`` (:423-723) and
``dist_graph_create_adjacent`` (:725-751).  Every topology operation
reduces to two communicator primitives, ``exchange(obj, pairs, fill)``
(one ppermute of a static pattern on the SPMD backend, point-to-point
sends on the host backends) and ``split_by_rank(color_fn, key_fn)`` (a
split computed on the host).  ``GraphComm``'s neighbor collectives branch
as the reference's do (:338) on whether the rank is an ``int`` (a host
rank) or batched (the SPMD program):

* host backends: a list with one payload per in-neighbor, in
  in-neighbor order (:366-386); tensors stay on the payload's device;
* SPMD: a stacked ``[max_degree, ...]`` tensor padded with ``fill``.
  This rank's rows of the host tables are picked with
  ``primitives.lookup`` in place of ``lax.axis_index`` and
  ``dynamic_index_in_dim``; the tables have one entry per world rank, so
  a graph over a split communicator runs in every sibling group.

``dist_graph_create_adjacent`` allgathers the per-rank lists on the host
backends and raises its ``TypeError`` under SPMD, as the reference does.

Rank-to-coordinate numbering is row-major (C order), matching MPI's
MPI_Cart_coords convention [S].
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from . import schedules
from .communicator import Communicator
from .gpu import primitives

Pair = Tuple[int, int]


def dims_create(nnodes: int, ndims: int) -> List[int]:
    """MPI_Dims_create [S]: factor ``nnodes`` into ``ndims`` balanced,
    non-increasing dimensions."""
    if nnodes <= 0 or ndims <= 0:
        raise ValueError("nnodes and ndims must be positive")
    dims = [1] * ndims
    n = nnodes
    # repeatedly peel the largest prime factor onto the smallest dimension
    factors: List[int] = []
    f = 2
    while f * f <= n:
        while n % f == 0:
            factors.append(f)
            n //= f
        f += 1
    if n > 1:
        factors.append(n)
    for f in sorted(factors, reverse=True):
        dims[dims.index(min(dims))] *= f
    return sorted(dims, reverse=True)


class CartComm:
    """A communicator with an attached N-D Cartesian topology.

    Wraps (never mutates) an existing communicator whose size must equal
    ``prod(dims)`` — MPI_Cart_create's "allow fewer ranks" escape hatch is
    not portable to SPMD, where every rank runs the program.
    """

    def __init__(self, comm: Communicator, dims: Sequence[int],
                 periods: Optional[Sequence[bool]] = None):
        dims = tuple(int(d) for d in dims)
        if any(d <= 0 for d in dims):
            raise ValueError(f"dims must be positive, got {dims}")
        if math.prod(dims) != comm.size:
            raise ValueError(
                f"prod(dims)={math.prod(dims)} must equal comm.size={comm.size}")
        periods = (tuple(bool(p) for p in periods) if periods is not None
                   else (False,) * len(dims))
        if len(periods) != len(dims):
            raise ValueError("periods must have one entry per dimension")
        self.comm = comm
        self.dims = dims
        self.periods = periods
        # row-major strides: stride[i] = prod(dims[i+1:])
        self._strides = tuple(
            math.prod(dims[i + 1:]) for i in range(len(dims)))

    # -- identity ----------------------------------------------------------

    @property
    def rank(self):
        return self.comm.rank

    @property
    def size(self) -> int:
        return self.comm.size

    @property
    def ndims(self) -> int:
        return len(self.dims)

    @property
    def coords(self):
        """This rank's coordinates: batched integer tensors inside the SPMD
        program (pure arithmetic on the rank)."""
        r = self.comm.rank
        return tuple((r // s) % d for s, d in zip(self._strides, self.dims))

    # -- pure coordinate math (host-side, any rank) ------------------------

    def coords_of(self, rank: int) -> Tuple[int, ...]:
        """MPI_Cart_coords [S]."""
        if not (0 <= rank < self.size):
            raise ValueError(f"rank {rank} out of range for size {self.size}")
        return tuple((rank // s) % d for s, d in zip(self._strides, self.dims))

    def rank_of(self, coords: Sequence[int]) -> Optional[int]:
        """MPI_Cart_rank [S]: periodic dimensions wrap; out-of-range
        coordinates on non-periodic dimensions return None (MPI_PROC_NULL)."""
        if len(coords) != self.ndims:
            raise ValueError(f"need {self.ndims} coordinates, got {len(coords)}")
        rank = 0
        for c, d, p, s in zip(coords, self.dims, self.periods, self._strides):
            c = int(c)
            if p:
                c %= d
            elif not (0 <= c < d):
                return None
            rank += c * s
        return rank

    def shift(self, dim: int, disp: int = 1) -> Tuple[Optional[int], Optional[int]]:
        """MPI_Cart_shift [S]: (source, dest) ranks for a displacement along
        ``dim``.  None is MPI_PROC_NULL.  Needs a concrete integer rank, so
        inside the SPMD program (batched rank) use ``exchange`` /
        ``shift_perm`` instead."""
        if not (0 <= dim < self.ndims):
            raise ValueError(f"dim {dim} out of range for {self.ndims}-D topology")
        r = self.comm.rank
        if not isinstance(r, int):
            raise TypeError(
                "CartComm.shift needs a concrete rank; inside an SPMD program "
                "the rank is traced (a batched tensor) — use "
                "cart.exchange(obj, dim, disp) (the whole-mesh halo exchange) "
                "instead")
        me = list(self.coords_of(r))
        me[dim] += disp
        dest = self.rank_of(me)
        me = list(self.coords_of(r))
        me[dim] -= disp
        src = self.rank_of(me)
        return src, dest

    def shift_perm(self, dim: int, disp: int = 1) -> List[Pair]:
        """The full static (src, dst) permutation of a shift along ``dim`` —
        exactly the pairs of the one ppermute the exchange lowers to."""
        if not (0 <= dim < self.ndims):
            raise ValueError(f"dim {dim} out of range for {self.ndims}-D topology")
        pairs: List[Pair] = []
        for r in range(self.size):
            c = list(self.coords_of(r))
            c[dim] += disp
            dst = self.rank_of(c)
            if dst is not None:
                pairs.append((r, dst))
        return pairs

    # -- communication -----------------------------------------------------

    def exchange(self, obj: Any, dim: int, disp: int = 1, fill: Any = None) -> Any:
        """Halo exchange along one dimension: every rank sends ``obj`` to its
        ``+disp`` neighbor and returns the payload from its ``-disp``
        neighbor; boundary holes (non-periodic) are ``fill``."""
        return self.comm.exchange(obj, self.shift_perm(dim, disp), fill=fill)

    def sendrecv_shift(self, obj: Any, dim: int, disp: int = 1,
                       fill: Any = None) -> Any:
        """Alias of :meth:`exchange` under its MPI name (Cart_shift +
        Sendrecv fused)."""
        return self.exchange(obj, dim, disp, fill)

    # -- neighborhood collectives [S: MPI-3 MPI_Neighbor_*] ----------------

    def neighbors_of(self, rank: int) -> List[Optional[int]]:
        """Neighbor ranks of ``rank`` in MPI's Cartesian neighbor order:
        for each dimension, the −1 neighbor then the +1 neighbor
        (None = MPI_PROC_NULL at a non-periodic boundary)."""
        out: List[Optional[int]] = []
        for dim in range(self.ndims):
            for disp in (-1, +1):
                c = list(self.coords_of(rank))
                c[dim] += disp
                out.append(self.rank_of(c))
        return out

    def neighbor_allgather(self, obj: Any, fill: Any = None) -> List[Any]:
        """MPI_Neighbor_allgather [S]: every rank contributes ``obj``; each
        rank returns ``[from −dim0, from +dim0, from −dim1, ...]`` — one
        entry per neighbor (``fill`` at non-periodic boundaries); 2·ndims
        ppermutes."""
        out: List[Any] = []
        for dim in range(self.ndims):
            # receive from the −dim neighbor = everyone ships one hop +dim
            out.append(self.exchange(obj, dim, +1, fill=fill))
            out.append(self.exchange(obj, dim, -1, fill=fill))
        return out

    def neighbor_alltoall(self, objs: Sequence[Any], fill: Any = None) -> List[Any]:
        """MPI_Neighbor_alltoall [S]: ``objs`` holds one distinct payload per
        neighbor in neighbor order (−dim0, +dim0, −dim1, ...); returns the
        payloads received from each neighbor, same order.  The item you
        address to your +dim neighbor arrives there as its −dim item."""
        if len(objs) != 2 * self.ndims:
            raise ValueError(
                f"need one payload per neighbor (2·ndims = {2 * self.ndims}), "
                f"got {len(objs)}")
        out: List[Any] = []
        for dim in range(self.ndims):
            # my item for the +dim neighbor rides the +1 shift; what lands
            # here on that shift is the −dim neighbor's +dim item
            out.append(self.exchange(objs[2 * dim + 1], dim, +1, fill=fill))
            out.append(self.exchange(objs[2 * dim], dim, -1, fill=fill))
        return out

    # -- topology management ----------------------------------------------

    def sub(self, remain_dims: Sequence[bool]) -> "CartComm":
        """MPI_Cart_sub [S]: drop the dimensions where ``remain_dims`` is
        False; ranks sharing the dropped coordinates form each new
        communicator, which keeps the remaining dimensions' topology."""
        remain = tuple(bool(k) for k in remain_dims)
        if len(remain) != self.ndims:
            raise ValueError(f"need {self.ndims} remain flags, got {len(remain)}")
        kept = [i for i, k in enumerate(remain) if k]
        dropped = [i for i, k in enumerate(remain) if not k]

        def color(rank: int) -> int:
            c = self.coords_of(rank)
            out = 0
            for i in dropped:
                out = out * self.dims[i] + c[i]
            return out

        def key(rank: int) -> int:
            c = self.coords_of(rank)
            out = 0
            for i in kept:
                out = out * self.dims[i] + c[i]
            return out

        sub = self.comm.split_by_rank(color, key)
        return CartComm(sub,
                        [self.dims[i] for i in kept] or [1],
                        [self.periods[i] for i in kept] or [False])

    def dup(self) -> "CartComm":
        return CartComm(self.comm.dup(), self.dims, self.periods)


def cart_create(comm: Communicator, dims: Sequence[int],
                periods: Optional[Sequence[bool]] = None) -> CartComm:
    """MPI_Cart_create [S] (reorder is meaningless here: ranks are mesh
    positions already)."""
    return CartComm(comm, dims, periods)


class GraphComm:
    """Arbitrary directed process graphs — MPI_(Dist_)graph topologies [S].

    The GLOBAL edge list is given (identical on every rank), so the whole
    neighborhood structure is static — what one SPMD program needs.
    Communication decomposes into partial-permutation rounds
    (``schedules.graph_rounds`` — greedy edge coloring), each one
    ``comm.exchange`` (one ppermute).  Results are stacked
    ``[max_in_degree, ...]`` tensors padded with ``fill``; rows
    ``[:in_degree(r)]`` follow rank r's in-neighbor order.
    """

    def __init__(self, comm: Communicator, edges: Sequence[Pair],
                 in_order: Optional[Sequence[Sequence[int]]] = None,
                 out_order: Optional[Sequence[Sequence[int]]] = None):
        self.comm = comm
        size = comm.size
        # neighbor order is the INPUT edge-list order — never the
        # coloring's round order, which would silently permute results;
        # in_order/out_order override it with each rank's own order
        # (MPI_Dist_graph_create_adjacent's contract), as the reference's
        # (mpi_tpu/topology.py:274-302)
        self.edges = schedules.dedupe_edges(edges, size)
        self._rounds = schedules.graph_rounds(self.edges, size)
        self._in: List[List[int]] = [[] for _ in range(size)]
        self._out: List[List[int]] = [[] for _ in range(size)]
        for s, d in self.edges:  # one O(E) pass
            self._in[d].append(s)
            self._out[s].append(d)
        for given, derived, what in ((in_order, self._in, "in_order"),
                                     (out_order, self._out, "out_order")):
            if given is None:
                continue
            for r in range(size):
                if sorted(given[r]) != sorted(derived[r]):
                    raise ValueError(
                        f"{what}[{r}]={list(given[r])} names a different "
                        f"neighbor set than the edges ({derived[r]})")
                derived[r] = [int(x) for x in given[r]]
        # round index of each (src, dst) edge
        self._round_of = {e: k for k, rnd in enumerate(self._rounds)
                          for e in rnd}

    # -- static queries (host-side) ----------------------------------------

    @property
    def size(self) -> int:
        return self.comm.size

    @property
    def rank(self):
        return self.comm.rank

    @property
    def n_rounds(self) -> int:
        return len(self._rounds)

    @property
    def max_in_degree(self) -> int:
        return max((len(n) for n in self._in), default=0)

    @property
    def max_out_degree(self) -> int:
        return max((len(n) for n in self._out), default=0)

    def in_neighbors_of(self, rank: int) -> List[int]:
        """MPI_Dist_graph_neighbors, incoming half (edge-list order)."""
        return list(self._in[rank])

    def out_neighbors_of(self, rank: int) -> List[int]:
        return list(self._out[rank])

    # -- neighborhood collectives [S: MPI-3 MPI_Neighbor_* over graphs] ----

    def _spmd(self) -> bool:
        return not isinstance(self.comm.rank, int)

    def _mine(self, rows: Sequence) -> torch.Tensor:
        """This rank's entry of a table indexed by comm rank (one entry per
        world rank, looked up by the world index)."""
        ranks = self.comm._rank_table
        return primitives.lookup([rows[ranks[w]] for w in range(len(ranks))])

    def _gather_receipts(self, receipts: List[Any], fill: Any):
        """Reorder per-round receipts into per-in-neighbor slots: slot k of
        rank r's output is the round its k-th in-edge ran in; padded rows
        point at round 0 and are overwritten with ``fill``."""
        size, maxd = self.size, self.max_in_degree
        if not receipts or maxd == 0:  # edgeless graph: static empty stack
            shape = () if not receipts else tuple(receipts[0].shape)
            return torch.zeros((0,) + shape, device=self.comm.device)
        table = [[self._round_of[(s, r)] for s in self._in[r]]
                 + [0] * (maxd - len(self._in[r])) for r in range(size)]
        stacked = torch.stack([primitives.as_tensor(x) for x in receipts])
        out = stacked[self._mine(table)]
        deg = self._mine([len(self._in[r]) for r in range(size)])
        mask = (torch.arange(maxd, device=out.device) < deg).reshape(
            (maxd,) + (1,) * (out.dim() - 1))
        return torch.where(mask, out, torch.full_like(out, fill))

    def neighbor_allgather(self, obj: Any, fill: Any = 0):
        """Every rank contributes ``obj``; each rank receives one payload
        per IN-neighbor (stacked, see the class docstring).  ``n_rounds``
        exchanges total."""
        receipts = [self.comm.exchange(obj, rnd, fill=fill)
                    for rnd in self._rounds]
        if not self._spmd():
            r = self.comm.rank
            return [receipts[self._round_of[(s, r)]] for s in self._in[r]]
        return self._gather_receipts(receipts, fill)

    def neighbor_alltoall(self, objs: Any, fill: Any = 0):
        """One DISTINCT payload per OUT-neighbor (a sequence in
        out-neighbor order on the host backends, stacked
        ``[max_out_degree, ...]`` under SPMD); returns the payloads
        received from each in-neighbor (allgather conventions)."""
        if not self._spmd():
            r = self.comm.rank
            if len(objs) != len(self._out[r]):
                raise ValueError(
                    f"rank {r}: need one payload per out-neighbor "
                    f"({len(self._out[r])}), got {len(objs)}")
            receipts = []
            for rnd in self._rounds:
                mine = next((d for (s, d) in rnd if s == r), None)
                payload = (objs[self._out[r].index(mine)]
                           if mine is not None else None)
                receipts.append(self.comm.exchange(payload, rnd, fill=fill))
            return [receipts[self._round_of[(s, r)]] for s in self._in[r]]
        x = primitives.as_tensor(objs)
        size, maxd = self.size, self.max_out_degree
        if x.shape[0] != maxd:
            raise ValueError(
                f"SPMD neighbor_alltoall payload needs leading dim == "
                f"max_out_degree ({maxd}), got {tuple(x.shape)}")
        # which out-block each rank ships in round k (0 when idle: the
        # exchange pattern has no edge from an idle rank, so the payload
        # choice is irrelevant — nothing is sent)
        send_slot = [[next((self._out[r].index(d) for (s, d) in rnd
                            if s == r), 0) for r in range(size)]
                     for rnd in self._rounds]
        receipts = [self.comm.exchange(x[self._mine(send_slot[k])], rnd, fill=fill)
                    for k, rnd in enumerate(self._rounds)]
        return self._gather_receipts(receipts, fill)


def graph_create(comm: Communicator, edges: Sequence[Pair]) -> GraphComm:
    """MPI_Dist_graph_create with the global edge list [S] (identical on
    every rank)."""
    return GraphComm(comm, edges)


def multihost_node_key(comm: Communicator):
    """Per-rank node ids of a multi-host world (``mpi_tpu/topology.py:423``):
    each rank contributes its process's index in the multi-process world
    (``gpu/multihost.py init_distributed``; the reference reads
    ``jax.process_index``, the DCN granule: one node per host, simulated
    hosts on one machine included) and the allgathered list becomes the
    pure ``node_key`` function the hierarchical splits need.  A world
    without an initialized ``torch.distributed`` of more than one process
    is one node, the reference's fallback and the truth for the
    single-host worlds the launcher starts; tests inject synthetic keys."""
    dom = 0
    dist = torch.distributed
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        dom = dist.get_rank()
    table = [int(d) for d in comm.allgather(dom)]
    return lambda r: table[r]


def split_hierarchical(comm: Communicator, node_key=None
                       ) -> Tuple[Communicator, Optional[Communicator],
                                  List[int]]:
    """The two-level split behind hierarchical collectives (Open MPI
    HAN's shape; ``mpi_tpu/topology.py:442``): ``(intra, leaders,
    node_of)`` where ``intra`` groups the ranks sharing ``node_key(rank)``
    (ordered by old rank, so the node's lowest rank is intra rank 0, the
    node leader), ``leaders`` holds exactly the leaders (None on the
    other ranks), and ``node_of[r]`` is rank r's dense node id (first
    appearance order, so node n is rank n of ``leaders``).

    ``node_key`` must be a pure function of the comm rank, identical on
    every rank (the split_by_rank contract).  Default: one node."""
    if node_key is None:
        node_key = lambda r: 0  # noqa: E731 - the single-host domain
    node_of = _dense([node_key(r) for r in range(comm.size)])
    intra = comm.split(node_of[comm.rank], key=comm.rank)
    leaders = comm.split(0 if intra.rank == 0 else None, key=comm.rank)
    return intra, leaders, node_of


def _dense(keys: List) -> List[int]:
    """Dense ids in first-appearance order (node n's leader, its lowest
    rank, is member n of any leader communicator keyed by old rank)."""
    order: dict = {}
    for k in keys:
        order.setdefault(k, len(order))
    return [order[k] for k in keys]


def split_hierarchical3(comm: Communicator, numa_key=None, node_key=None
                        ) -> Tuple[Communicator, Optional[Communicator],
                                   Optional[Communicator], List[int],
                                   List[int]]:
    """The three-level split (``mpi_tpu/topology.py:485``): ``(numa,
    node_leaders, dcn_leaders, numa_of, node_of)``.

    * ``numa`` groups the ranks sharing ``(node_key(r), numa_key(r))``,
      ordered by old rank: the domain's lowest rank is its leader;
    * ``node_leaders`` groups each node's NUMA leaders (None on the other
      ranks); its rank 0 is the node leader;
    * ``dcn_leaders`` groups the node leaders across nodes (None
      elsewhere); node n sits at its rank n.

    Both keys must be pure functions of the comm rank, identical on every
    rank.  ``node_key`` defaults to :func:`multihost_node_key` (one
    allgather), ``numa_key`` to one NUMA domain per node."""
    if numa_key is None:
        numa_key = lambda r: 0  # noqa: E731 - one NUMA domain per node
    if node_key is None:
        node_key = multihost_node_key(comm)
    numa_of = _dense([(node_key(r), numa_key(r)) for r in range(comm.size)])
    node_of = _dense([node_key(r) for r in range(comm.size)])
    numa = comm.split(numa_of[comm.rank], key=comm.rank)
    node_leaders = comm.split(node_of[comm.rank] if numa.rank == 0 else None,
                              key=comm.rank)
    node_leader = node_leaders is not None and node_leaders.rank == 0
    dcn_leaders = comm.split(0 if node_leader else None, key=comm.rank)
    return numa, node_leaders, dcn_leaders, numa_of, node_of


class HierarchicalComm:
    """Hierarchical collective dispatch over a two- or three-level split
    (``mpi_tpu/topology.py:542``): the intra tiers run on their own
    communicators (on the shm transport, the collective arena of
    ``coll_sm.py``) and the top tier runs the wire algorithms between the
    leaders only, so an allreduce moves each payload once per node over
    the wire: intra reduce, leaders allreduce, intra bcast.

    Two-level (default): ``node_key`` partitions the ranks into nodes.
    Three-level (with ``numa_key``): NUMA, node, DCN leaders; an allreduce
    climbs ``numa.reduce``, ``node_leaders.reduce``,
    ``dcn_leaders.allreduce`` and descends by bcast.  Every level's
    ``algorithm="auto"`` call consults the tuned-dispatch resolver
    (``tuning``) with its own (transport, size, payload) key, so the
    ``tuned_table_hits`` pvar counts one consult per level and member.

    Wraps (never mutates) an existing communicator, like CartComm.
    Tensors stay on their device; the fold order is the reference's."""

    def __init__(self, comm: Communicator, node_key=None,
                 inter_algorithm: str = "auto", numa_key=None):
        self.comm = comm
        self._inter = inter_algorithm
        if numa_key is None:
            self.numa = self.node_leaders = self.dcn_leaders = None
            self.intra, self.leaders, self._node_of = split_hierarchical(
                comm, node_key)
        else:
            (self.numa, self.node_leaders, self.dcn_leaders,
             self._numa_of, self._node_of) = split_hierarchical3(
                comm, numa_key, node_key)
            # the finest tier and the top tier under their two-level names
            self.intra = self.numa
            self.leaders = self.dcn_leaders
            numa_members: List[List[int]] = [
                [] for _ in range(max(self._numa_of) + 1)]
            for r, n in enumerate(self._numa_of):
                numa_members[n].append(r)
            self._numa_leader_of = [m[0] for m in numa_members]
        self._members: List[List[int]] = [
            [] for _ in range(max(self._node_of) + 1)]
        for r, n in enumerate(self._node_of):
            self._members[n].append(r)
        self._leader_of = [m[0] for m in self._members]

    # -- identity ----------------------------------------------------------

    @property
    def rank(self):
        return self.comm.rank

    @property
    def size(self) -> int:
        return self.comm.size

    @property
    def n_nodes(self) -> int:
        return len(self._members)

    def _hop(self, obj: Any, src: int, dst: int) -> Any:
        """One point-to-point hop on the full communicator (identity when
        src == dst); bystanders keep their own payload."""
        if src == dst:
            return obj
        got = self.comm.exchange(obj, [(src, dst)])
        return got if self.comm.rank == dst else obj

    # -- collectives -------------------------------------------------------

    def barrier(self) -> None:
        """Gather phase up every tier, release phase back down."""
        if self.numa is not None:
            self.numa.barrier()
            if self.node_leaders is not None:
                self.node_leaders.barrier()
                if self.dcn_leaders is not None:
                    self.dcn_leaders.barrier()
                self.node_leaders.barrier()
            self.numa.barrier()
            return
        self.intra.barrier()
        if self.leaders is not None:
            self.leaders.barrier()
        self.intra.barrier()

    def allreduce(self, obj: Any, op: Any = None) -> Any:
        from . import ops as _ops

        op = op or _ops.SUM
        if self.numa is not None:
            part = self.numa.reduce(obj, op, root=0)
            if self.node_leaders is not None:
                part = self.node_leaders.reduce(part, op, root=0)
                if self.dcn_leaders is not None:
                    part = self.dcn_leaders.allreduce(
                        part, op, algorithm=self._inter)
                part = self.node_leaders.bcast(part, root=0)
            return self.numa.bcast(part, root=0)
        part = self.intra.reduce(obj, op, root=0)
        if self.leaders is not None:
            part = self.leaders.allreduce(part, op, algorithm=self._inter)
        return self.intra.bcast(part, root=0)

    def reduce(self, obj: Any, op: Any = None, root: int = 0) -> Any:
        from . import ops as _ops

        op = op or _ops.SUM
        if self.numa is not None:
            # the three-level reduce rides the allreduce chain; only root
            # keeps the result
            val = self.allreduce(obj, op)
            return val if self.comm.rank == root else None
        part = self.intra.reduce(obj, op, root=0)
        rn = self._node_of[root]
        val = (self.leaders.reduce(part, op, root=rn)
               if self.leaders is not None else part)
        if self._node_of[self.comm.rank] != rn:
            return None
        # root's node: the node leader's total reaches root by the intra
        # bcast; the node's other ranks drop it
        val = self.intra.bcast(val, root=0)
        return val if self.comm.rank == root else None

    def bcast(self, obj: Any, root: int = 0) -> Any:
        if self.numa is not None:
            # climb root -> its NUMA leader -> its node leader; fan out by
            # the dcn, node and numa bcasts
            nl = self._numa_leader_of[self._numa_of[root]]
            top = self._leader_of[self._node_of[root]]
            obj = self._hop(obj, root, nl)
            obj = self._hop(obj, nl, top)
            if self.dcn_leaders is not None:
                obj = self.dcn_leaders.bcast(obj, root=self._node_of[root])
            if self.node_leaders is not None:
                obj = self.node_leaders.bcast(obj, root=0)
            return self.numa.bcast(obj, root=0)
        obj = self._hop(obj, root, self._leader_of[self._node_of[root]])
        if self.leaders is not None:
            obj = self.leaders.bcast(obj, root=self._node_of[root])
        return self.intra.bcast(obj, root=0)

    def allgather(self, obj: Any) -> Any:
        from .communicator import _maybe_stack

        if self.numa is not None:
            # (rank, payload) pairs climb the tiers as object lists and the
            # assembled world list descends by bcast
            got = self.numa.gather((self.comm.rank, obj), root=0)
            if self.node_leaders is not None:
                per = self.node_leaders.gather(got, root=0)
                if per is not None:
                    got = [pair for sub in per for pair in sub]
                if self.dcn_leaders is not None:
                    per_node = self.dcn_leaders.allgather([got])
                    got = [pair for (sub,) in per_node for pair in sub]
                got = self.node_leaders.bcast(got, root=0)
            got = self.numa.bcast(got, root=0)
            full: List[Any] = [None] * self.comm.size
            for rk, item in got:
                full[rk] = item
            return _maybe_stack(obj, full)
        node_items = self.intra.gather(obj, root=0)
        full = [None] * self.comm.size
        if self.leaders is not None:  # exactly the leaders (intra rank 0)
            per_node = self.leaders.allgather([list(node_items)])
            for n, (items,) in enumerate(per_node):
                for i, r in enumerate(self._members[n]):
                    full[r] = items[i]
        full = self.intra.bcast(full, root=0)
        return _maybe_stack(obj, full)


def dist_graph_create_adjacent(comm: Communicator, sources: Sequence[int],
                               destinations: Sequence[int]) -> GraphComm:
    """MPI_Dist_graph_create_adjacent [S]: every rank names ITS incoming
    ``sources`` and outgoing ``destinations``; on the host backends the
    global edge list is the allgathered union and each rank's neighbor
    order is its own lists' (``mpi_tpu/topology.py:725-751``).  One SPMD
    program cannot collect per-rank lists, so there, as under the
    reference's SPMD backend, it raises and names ``graph_create``."""
    r = comm.rank
    if not isinstance(r, int):
        raise TypeError(
            "dist_graph_create_adjacent needs per-rank adjacency lists, "
            "which an SPMD trace cannot collect — pass the global edge "
            "list to graph_create instead")
    local = ([int(s) for s in sources], [int(d) for d in destinations])
    gathered = comm.allgather(local)  # [(sources, destinations)] per rank
    seen, edges = set(), []
    for rk, (srcs, dsts) in enumerate(gathered):
        for e in [(s, rk) for s in srcs] + [(rk, d) for d in dsts]:
            if e not in seen:
                seen.add(e)
                edges.append(e)
    return GraphComm(comm, edges,
                     in_order=[srcs for srcs, _ in gathered],
                     out_order=[dsts for _, dsts in gathered])
