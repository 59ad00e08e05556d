"""The SPMD world on one device: the rank context and the communication
primitives every collective is built from.

The reference runs a rank as an index on a mesh axis inside
``jax.shard_map`` and communicates with ``lax.ppermute`` / ``lax.psum`` /
``lax.all_gather`` / ``lax.all_to_all``.  Here ``run_spmd`` runs the
per-rank program under ``torch.vmap`` over a leading rank dimension, and
each primitive is a ``torch.library.custom_op`` whose ``register_vmap``
rule receives the physical ``[P, ...]`` world tensor: a ppermute is a
permutation of the rank dimension, a psum a reduction over it.  The fused
reduction is a ``torch.autograd.Function`` with a ``vmap`` rule instead,
so that its SUM is differentiable inside the rank vmap.

Every primitive takes the batched world index as an argument, so its vmap rule always runs — even for a payload that is the
same on every rank — and the op's own implementation is reached only by
calling it outside ``run_spmd``, which raises.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

import torch
from torch._guards import detect_fake_mode

Pair = Tuple[int, int]


class SpmdContextError(RuntimeError):
    """A communication primitive was called outside ``run_spmd``."""


def _outside(name: str) -> SpmdContextError:
    return SpmdContextError(
        f"{name} is a collective of the SPMD world: call it inside "
        f"mpi_tpu_torch.run / run_spmd, where the rank dimension exists")


class _World:
    __slots__ = ("idx", "nranks", "device")

    def __init__(self, idx: torch.Tensor, nranks: int, device: torch.device):
        self.idx = idx
        self.nranks = nranks
        self.device = device


_STACK: List[_World] = []


@contextlib.contextmanager
def world(idx: torch.Tensor, nranks: int, device: torch.device):
    """Bind the batched world index for the duration of one SPMD call."""
    _STACK.append(_World(idx, nranks, device))
    try:
        yield
    finally:
        _STACK.pop()


def current(name: str = "this collective", nranks: Optional[int] = None) -> _World:
    if not _STACK:
        raise _outside(name)
    w = _STACK[-1]
    if nranks is not None and nranks != w.nranks:
        raise ValueError(
            f"communicator spans {nranks} ranks but the running SPMD world "
            f"has {w.nranks}")
    return w


def host_table(values, device, dtype=None) -> torch.Tensor:
    """A constant built on the host and copied to ``device``: the same H2D
    copy as ``torch.as_tensor(values, device=device)``, spelled so that a
    trace on fake tensors records it (the constant stays on the host and
    its copy is a graph node) even for a device this host has no card for:
    ``copy_`` into a new tensor, since a trace evaluates an op whose inputs
    are all one-element constants (``.to`` of the table) for real."""
    table = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type == "cpu":
        return table
    return torch.empty(table.shape, dtype=table.dtype, device=device).copy_(table)


def lookup(values: Sequence, dtype=torch.long) -> torch.Tensor:
    """``values[world index]`` for a host table with one entry per world rank."""
    w = current("lookup")
    return host_table(list(values), w.device, dtype)[w.idx]


def as_tensor(obj) -> torch.Tensor:
    """A payload as a tensor on the running world's device."""
    w = current("as_tensor")
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == w.device else obj.to(w.device)
    return host_table(obj, w.device)


def as_world(x: torch.Tensor, dim: Optional[int], nranks: int) -> torch.Tensor:
    """The physical ``[P, ...]`` world of a vmap-rule operand: batched
    operands move their rank dimension to the front; an unbatched one is
    the same value on every rank (``in_specs=P()``) and is expanded."""
    if dim is None:
        return x.unsqueeze(0).expand(nranks, *x.shape).contiguous()
    return x.movedim(dim, 0).contiguous()


def _members(groups: Sequence[int], size: int) -> List[List[int]]:
    """``[P, size]`` table: row w lists the world ranks of w's group."""
    n = len(groups)
    rows = [None] * n
    for g0 in range(0, n, size):
        g = list(groups[g0:g0 + size])
        for w in g:
            rows[w] = g
    return rows


def _positions(groups: Sequence[int], size: int) -> List[int]:
    pos = [0] * len(groups)
    for i, w in enumerate(groups):
        pos[w] = i % size
    return pos


# -- ppermute ---------------------------------------------------------------


@torch.library.custom_op("mpi_tpu_torch::ppermute", mutates_args=())
def _ppermute(x: torch.Tensor, rank: torch.Tensor, src: List[int],
              dst: List[int]) -> torch.Tensor:
    raise _outside("ppermute")


def _ppermute_vmap(info, in_dims, x, rank, src, dst):
    w = as_world(x, in_dims[0], info.batch_size)
    out = torch.zeros_like(w)
    if src:
        out = out.index_copy(0, host_table(list(dst), w.device),
                             w.index_select(0, host_table(list(src), w.device)))
    return out, 0


_ppermute.register_vmap(_ppermute_vmap)


def ppermute(x, pairs: Sequence[Pair]) -> torch.Tensor:
    """``lax.ppermute``: rank ``d`` receives rank ``s``'s payload for every
    world-level ``(s, d)``; ranks receiving nothing get zeros."""
    w = current("ppermute")
    x = as_tensor(x)
    return _ppermute(x, w.idx, [int(s) for s, _ in pairs],
                     [int(d) for _, d in pairs])


# -- fused group collectives -----------------------------------------------


class _GroupReduce(torch.autograd.Function):
    """The fused allreduce as a world-level op: its ``vmap`` rule reduces
    the ``[P, ...]`` world over each group.  An ``autograd.Function`` (not
    a ``custom_op``) so that ``torch.func.grad`` inside the rank vmap can
    differentiate through it.

    The SUM backward is JAX's transpose of ``lax.psum`` whose result fed
    replicated computation: each rank keeps its cotangent (the gradient of
    one copy of the replicated loss, as in the tensor-parallel loss of
    ``entry._build_step``).  JAX sums cotangents not here but at the
    ``pvary`` its varying-axes typing inserts where a replicated value
    meets rank-varying ones; the port has no such typing, and
    ``comm.localize`` is that ``pvary``, written out.  Cotangents that
    differ across a group mean a ``pvary`` is missing, and no rule on the
    cotangents alone can place it: ``h + psum(f(h, w_r))`` must sum only
    the ``f`` branch.  So the backward raises there, naming
    ``comm.localize`` (``_GroupCotangent``).  The reference's 1-D
    ``split_by`` spelling (``psum_scatter`` + ``all_gather``,
    ``tpu/communicator.py:455``) always sums."""

    @staticmethod
    def forward(x, rank, groups, size, op):
        raise _outside("group_reduce")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])
        ctx.config = (inputs[2], inputs[3])
        ctx.op = inputs[4]

    @staticmethod
    def backward(ctx, grad):
        if ctx.op != "sum":
            raise RuntimeError(
                f"the fused {ctx.op.upper()} allreduce has no gradient (nor "
                f"has lax.p{ctx.op} in the reference); only SUM is "
                f"differentiable")
        rank, = ctx.saved_tensors
        return (_GroupCotangent.apply(grad, None, rank, *ctx.config),
                None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, rank, groups, size, op):
        w = as_world(x, in_dims[0], info.batch_size)
        stacked = w[host_table(_members(groups, size), w.device)]  # [P, size, ...]
        if op == "sum":
            out = torch.sum(stacked, dim=1, dtype=w.dtype)
        elif op == "max":
            out = torch.amax(stacked, dim=1)
        elif op == "min":
            out = torch.amin(stacked, dim=1)
        else:
            raise ValueError(f"group_reduce supports sum/max/min, got {op!r}")
        return out, 0


def _by_group(w: torch.Tensor, groups: Sequence[int], size: int) -> torch.Tensor:
    """The ``[P, ...]`` world as ``[G, size, ...]``, group by group in
    group-rank order: a view when the groups are the ranks in order (the
    dry run's mp rows), one gather otherwise."""
    if list(groups) != list(range(len(groups))):
        w = w.index_select(0, host_table(list(groups), w.device))
    return w.reshape((len(groups) // size, size) + tuple(w.shape[1:]))


def _group_of(groups: Sequence[int], size: int, device) -> torch.Tensor:
    """``[P]``: the group index of each world rank."""
    of = [0] * len(groups)
    for i, r in enumerate(groups):
        of[r] = i // size
    return host_table(of, device)


def _replicated(wg: torch.Tensor) -> torch.Tensor:
    """``[G]`` bool of a ``_by_group`` world: does the group hold ``size``
    bitwise-equal values?  (The value-level stand-in for JAX's typing of a
    value as invariant over the axis.)"""
    return (wg == wg[:, :1]).reshape(wg.shape[0], -1).all(dim=1)


def _per_rank(mask: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (w.dim() - 1))


# under 255 characters: the card's ``aten._assert_async`` takes no longer message
_MISSING_LOCALIZE = (
    "fused SUM allreduce: cotangents differ across a group, so a replicated "
    "value met rank-varying ones unmarked; wrap each such use in "
    "comm.localize (JAX's pvary), e.g. h + allreduce(f(comm.localize(h), w_r))")


def _require(ok: torch.Tensor, msg: str) -> None:
    """Raise ``msg`` unless the bool tensor ``ok`` holds.  Under a trace on
    fake tensors the check is an ``aten._assert_async`` graph node (there
    is no value to branch on); it raises on the CPU and traps on the card
    when the traced program runs."""
    if detect_fake_mode((ok,)) is not None:
        torch._assert_async(ok, msg)
    elif not bool(ok):
        raise RuntimeError(msg)


class _GroupCotangent(torch.autograd.Function):
    """A backward of the fused SUM as a world-level op.  ``mask=None`` is
    the SUM allreduce's rule: each rank keeps its cotangent, which must be
    equal across its group (else it raises, see ``_GroupReduce``).  With
    the per-rank ``mask`` that ``comm.localize`` recorded, the ranks it
    marks take the group sum (the transpose of ``pvary``) and the others
    keep theirs."""

    @staticmethod
    def forward(grad, mask, rank, groups, size):
        raise _outside("a fused backward")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the fused allreduce has no second derivative in the port")

    @staticmethod
    def vmap(info, in_dims, grad, mask, rank, groups, size):
        w = as_world(grad, in_dims[0], info.batch_size)
        if mask is not None:
            mask = as_world(mask, in_dims[1], info.batch_size)
        return group_cotangent_world(w, groups, size, mask), 0


def group_cotangent_world(w: torch.Tensor, groups: Sequence[int], size: int,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``_GroupCotangent`` on the ``[P, ...]`` world of cotangents.  With
    ``mask=None``: ``w`` itself, once every group is checked to hold equal
    cotangents.  With a ``[P]`` ``mask``: each group summed once over its
    members (``[G, ...]``) and handed to its marked ranks; the unmarked
    keep their own."""
    wg = _by_group(w, groups, size)
    if mask is None:
        _require(_replicated(wg).all(), _MISSING_LOCALIZE)
        return w
    total = wg.sum(dim=1)[_group_of(groups, size, w.device)]
    return torch.where(_per_rank(mask, w), total, w)


class _Localize(torch.autograd.Function):
    """``comm.localize`` as a world-level op (the reference's
    ``localize``, ``tpu/communicator.py:274``): the identity forward,
    which records where the group's values are all equal (where the
    reference's ``pvary`` would brand an invariant value varying); the
    backward sums the cotangents over the group there, and passes them
    through elsewhere (``pvary`` of a value already varying is a no-op)."""

    @staticmethod
    def forward(x, rank, groups, size):
        raise _outside("localize")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output[1], inputs[1])
        ctx.config = (inputs[2], inputs[3])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, grad, _):
        mask, rank = ctx.saved_tensors
        return (_GroupCotangent.apply(grad, mask, rank, *ctx.config),
                None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, rank, groups, size):
        n = info.batch_size
        if in_dims[0] is None:  # the same value on every rank
            same = torch.ones(n, dtype=torch.bool, device=x.device)
        else:
            wg = _by_group(x.movedim(in_dims[0], 0), groups, size)
            same = _replicated(wg)[_group_of(groups, size, x.device)]
        return (x.view_as(x), same), (in_dims[0], 0)


def localize(x, groups: Sequence[int], size: int) -> torch.Tensor:
    """Mark ``x`` as rank-varying over the groups: the value is unchanged;
    where a group's values are all equal, a gradient through it is summed
    over the group."""
    w = current("localize")
    return _Localize.apply(as_tensor(x), w.idx, list(groups), size)[0]


def group_reduce(x, groups: Sequence[int], size: int, op: str) -> torch.Tensor:
    """Fused allreduce (``lax.psum``/``pmax``/``pmin`` with
    ``axis_index_groups``): plain torch over the rank dimension, as XLA
    computed it outside any Pallas kernel.  ``groups`` is the flattened
    partition (the whole axis for an unsplit communicator).  SUM is
    differentiable (see ``_GroupReduce``)."""
    w = current("group_reduce")
    return _GroupReduce.apply(as_tensor(x), w.idx, list(groups), size, op)


@torch.library.custom_op("mpi_tpu_torch::all_gather", mutates_args=())
def _all_gather(x: torch.Tensor, rank: torch.Tensor, groups: List[int],
                size: int) -> torch.Tensor:
    raise _outside("all_gather")


def _all_gather_vmap(info, in_dims, x, rank, groups, size):
    w = as_world(x, in_dims[0], info.batch_size)
    return w[host_table(_members(groups, size), w.device)], 0


_all_gather.register_vmap(_all_gather_vmap)


def all_gather(x, groups: Sequence[int], size: int) -> torch.Tensor:
    """``lax.all_gather(tiled=False)``: the stacked ``[size, ...]`` group
    payloads in group-rank order."""
    w = current("all_gather")
    return _all_gather(as_tensor(x), w.idx, list(groups), size)


@torch.library.custom_op("mpi_tpu_torch::all_to_all", mutates_args=())
def _all_to_all(x: torch.Tensor, rank: torch.Tensor, groups: List[int],
                size: int) -> torch.Tensor:
    raise _outside("all_to_all")


def _all_to_all_vmap(info, in_dims, x, rank, groups, size):
    w = as_world(x, in_dims[0], info.batch_size)  # [P, size, ...]
    members = host_table(_members(groups, size), w.device)
    pos = host_table(_positions(groups, size), w.device)
    return w[members, pos[:, None]], 0


_all_to_all.register_vmap(_all_to_all_vmap)


def all_to_all(x, groups: Sequence[int], size: int) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0)``: block j of the
    result is group rank j's block for this rank."""
    w = current("all_to_all")
    return _all_to_all(as_tensor(x), w.idx, list(groups), size)


# -- per-rank random numbers -------------------------------------------------


@torch.library.custom_op("mpi_tpu_torch::rank_uniform", mutates_args=())
def _rank_uniform(rank: torch.Tensor, seed: int, shape: List[int]) -> torch.Tensor:
    raise _outside("rank_uniform")


def _rank_draws(draw, rank, in_dims, nranks, seed, shape):
    ranks = as_world(rank, in_dims[0], nranks)
    out = []
    # the draws are plain per-rank calls: keep the vmap layer's random-op
    # interception (which would batch or refuse them) out of the way
    with torch._C._ExcludeDispatchKeyGuard(
            torch._C.DispatchKeySet(torch._C.DispatchKey.FuncTorchVmapMode)):
        for r in ranks.tolist():
            gen = torch.Generator(device=ranks.device)
            gen.manual_seed(seed * 1_000_003 + int(r))
            out.append(draw(shape, generator=gen, device=ranks.device))
    return torch.stack(out), 0


def _rank_uniform_vmap(info, in_dims, rank, seed, shape):
    return _rank_draws(torch.rand, rank, in_dims, info.batch_size, seed, shape)


_rank_uniform.register_vmap(_rank_uniform_vmap)


@torch.library.custom_op("mpi_tpu_torch::rank_normal", mutates_args=())
def _rank_normal(rank: torch.Tensor, seed: int, shape: List[int]) -> torch.Tensor:
    raise _outside("rank_normal")


def _rank_normal_vmap(info, in_dims, rank, seed, shape):
    return _rank_draws(torch.randn, rank, in_dims, info.batch_size, seed, shape)


_rank_normal.register_vmap(_rank_normal_vmap)


# The host layer's rank of the calling thread (a rank thread of the local
# backend) or process (a socket rank): ``(world rank, device)``, bound by
# the host runners so that a program's per-rank draws run there too.
_HOST = threading.local()
_HOST_PROCESS: List[Tuple[int, torch.device]] = []


def bind_host_rank(rank: int, device: torch.device, process: bool = False) -> None:
    """Bind the host rank whose stream ``rank_uniform`` / ``rank_normal``
    draw from outside an SPMD world (this thread's, or the process's)."""
    if process:
        _HOST_PROCESS[:] = [(rank, device)]
    else:
        _HOST.rank = (rank, device)


def unbind_host_process() -> None:
    """Undo ``bind_host_rank(..., process=True)`` (at ``finalize``): a draw
    outside any world raises again."""
    _HOST_PROCESS.clear()


def _bound_host_rank() -> Optional[Tuple[int, torch.device]]:
    return getattr(_HOST, "rank", None) or (_HOST_PROCESS[0] if _HOST_PROCESS
                                            else None)


def host_rank_device() -> Optional[torch.device]:
    """The device of the host rank bound to this thread or process (None
    outside any host world)."""
    bound = _bound_host_rank()
    return None if bound is None else bound[1]


def _host_draw(draw, name: str, shape: Sequence[int], seed: int) -> torch.Tensor:
    bound = _bound_host_rank()
    if bound is None:
        raise _outside(name)
    rank, device = bound
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + rank)
    return draw([int(s) for s in shape], generator=gen, device=device)


def rank_normal(shape: Sequence[int], seed: int) -> torch.Tensor:
    """Standard normal float32 samples from this rank's own
    ``torch.Generator`` (seeded as ``rank_uniform``) — the counterpart of
    ``jax.random.normal`` under ``fold_in(PRNGKey(seed), rank)``."""
    if not _STACK:
        return _host_draw(torch.randn, "rank_normal", shape, seed)
    w = current("rank_normal")
    return _rank_normal(w.idx, int(seed), [int(s) for s in shape])


def rank_uniform(shape: Sequence[int], seed: int) -> torch.Tensor:
    """Uniform [0, 1) float32 samples from this rank's own
    ``torch.Generator``, seeded from ``(seed, world rank)`` — the
    counterpart of ``jax.random.fold_in(PRNGKey(seed), rank)``.  The
    streams differ from JAX's.  On a host rank (the local and socket
    backends) the same stream is drawn eagerly, so a program's samples are
    the same on every backend."""
    if not _STACK:
        return _host_draw(torch.rand, "rank_uniform", shape, seed)
    w = current("rank_uniform")
    return _rank_uniform(w.idx, int(seed), [int(s) for s in shape])
