"""Flat MPI_* function layer: thin wrappers over the world communicator so
classic MPI-style programs read naturally::

    from mpi_tpu_torch.api import *
    MPI_Init()
    rank = MPI_Comm_rank()
    if rank == 0:
        MPI_Send(data, dest=1)
    ...
    MPI_Finalize()

The port's own copy of ``mpi_tpu/api.py`` (:1-1457), with the same names
and signatures, over the port's host communicators (tensors stay on their
device).  Run such a program with ``python -m mpi_tpu_torch.launcher -n 4
prog.py`` (add ``--device cpu`` without a card).  Differences:

* the typed ``MPI_Send`` / ``MPI_Recv`` (``datatype=``) take numpy arrays
  (the reference's host path, ``Datatype.pack`` / ``unpack``) and tensors
  (``pack_torch``, and ``unpack_torch`` copied back into ``buf`` in place,
  on ``buf``'s device);
* the MPI-IO reads (``MPI_File_read*``) return tensors on the
  communicator's device (``io.py``), and spawned children
  (``MPI_Comm_spawn*``, ``spawn.py``) run on the card unless
  ``MPI_TPU_DEVICE`` says otherwise.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from . import datatypes, errors, ops
from . import communicator as _comm
from .communicator import Communicator, Status
from .group import Group
from .transport.base import ANY_SOURCE, ANY_TAG

__all__ = [
    "MPI_Init", "MPI_Finalize", "MPI_Initialized", "MPI_COMM_WORLD",
    "MPI_Comm_rank", "MPI_Comm_size", "MPI_Send", "MPI_Recv", "MPI_Sendrecv",
    "MPI_Isendrecv", "MPI_Isendrecv_replace",
    "MPI_Bcast", "MPI_Reduce", "MPI_Allreduce", "MPI_Allgather", "MPI_Alltoall",
    "MPI_Barrier", "MPI_Comm_split", "MPI_Comm_dup", "MPI_Scatter", "MPI_Gather",
    "MPI_Scan", "MPI_Reduce_scatter", "MPI_Isend", "MPI_Irecv", "MPI_Wait",
    "MPI_Test", "MPI_Waitall", "MPI_Waitany", "MPI_Waitsome", "MPI_Testall",
    "MPI_Testany", "MPI_Probe", "MPI_Iprobe", "MPI_Wtime",
    "MPI_Mprobe", "MPI_Improbe", "MPI_Mrecv",
    "MPI_Send_init", "MPI_Recv_init", "MPI_Start", "MPI_Startall",
    "MPI_Ibcast", "MPI_Ireduce", "MPI_Iallreduce", "MPI_Iallgather",
    "MPI_Ialltoall", "MPI_Ibarrier", "MPI_Iscatter", "MPI_Igather",
    "MPI_Get_processor_name", "MPI_Get_version", "MPI_Get_library_version", "MPI_Abort",
    "MPI_Wtick", "MPI_Sendrecv_replace",
    "MPI_Exscan", "MPI_Op_create", "MPI_Maxloc", "MPI_Minloc",
    "MPI_Gatherv", "MPI_Scatterv", "MPI_Allgatherv", "MPI_Alltoallv",
    "MPI_Cart_create", "MPI_Dims_create", "MPI_Cart_coords", "MPI_Cart_rank",
    "MPI_Graph_create", "MPI_Dist_graph_create_adjacent",
    "MPI_Intercomm_create", "MPI_Intercomm_merge",
    "MPI_Comm_remote_size", "MPI_Comm_test_inter",
    "MPI_Cart_shift", "MPI_Cart_sub",
    "MPI_Neighbor_allgather", "MPI_Neighbor_alltoall",
    "MPI_Comm_group", "MPI_Comm_create", "MPI_Comm_create_group",
    "MPI_Win_create", "MPI_Win_fence", "MPI_Win_free",
    "MPI_Win_lock", "MPI_Win_unlock",
    "MPI_Win_post", "MPI_Win_start", "MPI_Win_complete", "MPI_Win_wait",
    "MPI_Win_test", "MPI_Fetch_and_op", "MPI_Compare_and_swap",
    "MPI_Win_flush", "MPI_Comm_split_type", "MPI_COMM_TYPE_SHARED",
    "MPI_Win_lock_all", "MPI_Win_unlock_all", "MPI_Win_flush_all",
    "MPI_Win_flush_local", "MPI_Get_accumulate",
    "MPI_Rput", "MPI_Rget", "MPI_Raccumulate", "MPI_Comm_idup",
    "MPI_Type_create_hvector", "MPI_Type_create_hindexed",
    "MPI_Win_allocate_shared", "MPI_Win_shared_query", "MPI_Win_sync",
    "MPI_Win_create_dynamic", "MPI_Win_attach", "MPI_Win_detach",
    "MPI_T_cvar_list", "MPI_T_cvar_read", "MPI_T_cvar_write",
    "MPI_T_pvar_list", "MPI_T_pvar_read", "MPI_T_pvar_session_create",
    "MPI_Bcast_init", "MPI_Allreduce_init", "MPI_Reduce_init",
    "MPI_Allgather_init", "MPI_Alltoall_init", "MPI_Barrier_init",
    "MPI_Reduce_scatter_init",
    "MPI_Session_init", "MPI_Session_finalize", "MPI_Session_get_num_psets",
    "MPI_Session_get_nth_pset", "MPI_Session_get_info",
    "MPI_Group_from_session_pset", "MPI_Comm_create_from_group",
    "MPI_Psend_init", "MPI_Precv_init", "MPI_Pready", "MPI_Pready_range",
    "MPI_Parrived",
    "MPI_Put", "MPI_Get", "MPI_Accumulate",
    "MPI_Group_incl", "MPI_Group_excl", "MPI_Group_union",
    "MPI_Group_intersection", "MPI_Group_difference", "MPI_Group_size",
    "MPI_Group_rank", "MPI_Group_translate_ranks", "Group",
    "MPI_Type_contiguous", "MPI_Type_vector", "MPI_Type_indexed",
    "MPI_Type_create_subarray", "MPI_Type_create_struct",
    "MPI_Type_create_resized", "MPI_Type_commit", "MPI_Type_free",
    "MPI_Type_size", "MPI_Type_get_extent",
    "MPI_Pack", "MPI_Unpack", "MPI_Pack_size", "Datatype",
    "MPI_Pack_external", "MPI_Unpack_external",
    "MPI_COMM_SELF", "MPI_Get_count", "MPI_Get_elements",
    "MPI_SUCCESS", "MPI_ERRORS_ARE_FATAL", "MPI_ERRORS_RETURN",
    "MPI_Error_class", "MPI_Error_string", "ErrorCode",
    "MPI_Comm_set_errhandler", "MPI_Comm_get_errhandler",
    "MPI_ERR_PROC_FAILED", "MPI_ERR_REVOKED",
    "MPIX_Comm_revoke", "MPIX_Comm_shrink", "MPIX_Comm_agree",
    "MPIX_Comm_failure_ack", "MPIX_Comm_failure_get_acked",
    "MPIX_Comm_get_failed",
    "MPIX_Comm_accept_rejoin", "MPIX_Comm_rejoin", "MPIX_Comm_get_epoch",
    "MPI_Errhandler_create",
    "MPI_Comm_create_keyval", "MPI_Comm_free_keyval", "MPI_COMM_DUP_FN",
    "MPI_COMM_NULL_COPY_FN", "MPI_NO_COPY", "Keyval",
    "MPI_Comm_set_attr", "MPI_Comm_get_attr", "MPI_Comm_delete_attr",
    "MPI_Comm_spawn", "MPI_Comm_spawn_multiple", "MPI_Comm_get_parent",
    "MPI_Open_port", "MPI_Close_port", "MPI_Comm_accept", "MPI_Comm_connect",
    "MPI_Publish_name", "MPI_Unpublish_name", "MPI_Lookup_name",
    "MPI_File_open", "MPI_File_close", "MPI_File_delete",
    "MPI_File_read_at", "MPI_File_write_at",
    "MPI_File_read_at_all", "MPI_File_write_at_all",
    "MPI_File_seek", "MPI_File_get_position", "MPI_File_read", "MPI_File_write",
    "MPI_File_read_shared", "MPI_File_write_shared", "MPI_File_seek_shared",
    "MPI_File_write_ordered", "MPI_File_read_ordered",
    "Info", "MPI_INFO_NULL", "MPI_Info_create", "MPI_Info_set",
    "MPI_Info_get", "MPI_Info_delete", "MPI_Info_dup", "MPI_Info_free",
    "MPI_Info_get_nkeys",
    "MPI_File_set_view", "MPI_File_get_view", "MPI_Register_datarep",
    "MPI_File_get_size", "MPI_File_set_size", "MPI_File_preallocate",
    "MPI_File_sync",
    "MPI_MODE_RDONLY", "MPI_MODE_WRONLY", "MPI_MODE_RDWR", "MPI_MODE_CREATE",
    "MPI_MODE_EXCL", "MPI_MODE_APPEND", "MPI_MODE_DELETE_ON_CLOSE",
    "MPI_SEEK_SET", "MPI_SEEK_CUR", "MPI_SEEK_END",
    "ANY_SOURCE", "ANY_TAG", "SUM", "PROD", "MAX", "MIN",
    "LAND", "LOR", "LXOR", "BAND", "BOR", "BXOR", "Status",
]

SUM, PROD, MAX, MIN = ops.SUM, ops.PROD, ops.MAX, ops.MIN
LAND, LOR, LXOR = ops.LAND, ops.LOR, ops.LXOR
BAND, BOR, BXOR = ops.BAND, ops.BOR, ops.BXOR
MPI_Op_create = ops.make_op


def _world(comm: Optional[Communicator]) -> Communicator:
    if comm is not None:
        return comm
    from . import init

    return init()


def _call(comm: Optional[Communicator], method: str, *args: Any, **kwargs: Any) -> Any:
    """Invoke a communicator method under its error handler (MPI-1 §7,
    errors.py): ERRORS_ARE_FATAL propagates the exception,
    ERRORS_RETURN yields an ErrorCode in place of the result, a callable
    handler decides.  This boundary is the MPI_* layer only — the object
    API stays exception-raising (pythonic)."""
    c = _world(comm)
    try:
        return getattr(c, method)(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 - classified by the handler
        return errors.invoke_handler(c, exc)


def MPI_Init(backend: Optional[str] = None) -> Communicator:
    from . import init

    return init(backend)


def MPI_Initialized() -> bool:
    from . import is_initialized

    return is_initialized()


def MPI_Finalize() -> None:
    from . import finalize

    finalize()


def MPI_COMM_WORLD() -> Communicator:
    return _world(None)


def MPI_Comm_rank(comm: Optional[Communicator] = None) -> int:
    return _world(comm).rank


def MPI_Comm_size(comm: Optional[Communicator] = None) -> int:
    return _world(comm).size


def MPI_Send(obj: Any, dest: int, tag: int = 0, comm: Optional[Communicator] = None,
             datatype: Optional[datatypes.Datatype] = None, count: int = 1) -> None:
    """With ``datatype=``, ``obj`` is the typed base buffer and the wire
    payload is ``datatype.pack(obj, count)`` — the MPI typed-send spelling
    (strided columns, halo faces, structs; datatypes.py)."""
    c = _world(comm)
    try:
        payload = _pack(datatype, obj, count) if datatype is not None else obj
        return c.send(payload, dest, tag)
    except Exception as exc:  # noqa: BLE001 - pack errors honor the handler too
        return errors.invoke_handler(c, exc)


def MPI_Recv(source: int = ANY_SOURCE, tag: int = ANY_TAG,
             comm: Optional[Communicator] = None,
             status: Optional[Status] = None,
             datatype: Optional[datatypes.Datatype] = None,
             buf: Optional[Any] = None, count: int = 1) -> Any:
    """With ``datatype=`` and ``buf=``, the received contiguous payload is
    scattered into ``buf`` in-place (the typed-recv spelling); ``buf`` is
    returned."""
    c = _world(comm)
    try:
        if (buf is None) != (datatype is None):
            raise ValueError("typed MPI_Recv needs BOTH datatype= and buf= "
                             "(one without the other would silently drop the "
                             "layout or leave buf unfilled)")
        obj = c.recv(source, tag, status)
        if datatype is not None:
            return _unpack(datatype, obj, buf, count)
        return obj
    except Exception as exc:  # noqa: BLE001 - unpack errors honor the handler;
        # a handler's fallback value is returned as-is, never unpacked into buf
        return errors.invoke_handler(c, exc)


def _pack(datatype: datatypes.Datatype, obj: Any, count: int) -> Any:
    """The typed send's wire payload: a tensor is gathered on its device,
    anything else by the numpy host path."""
    if isinstance(obj, torch.Tensor):
        return datatype.pack_torch(obj, count)
    return datatype.pack(obj, count)


def _unpack(datatype: datatypes.Datatype, obj: Any, buf: Any,
            count: int) -> Any:
    """Scatter a received contiguous payload into ``buf`` in place: a
    tensor ``buf`` on its own device, an ndarray by the host path."""
    if isinstance(buf, torch.Tensor):
        buf.copy_(datatype.unpack_torch(obj, buf, count))
        return buf
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    return datatype.unpack(obj, buf, count)


def MPI_Sendrecv(sendobj: Any, dest: int, source: int = ANY_SOURCE,
                 sendtag: int = 0, recvtag: int = ANY_TAG,
                 comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "sendrecv", sendobj, dest, source, sendtag, recvtag)


def MPI_Isendrecv(sendobj: Any, dest: int, source: int = ANY_SOURCE,
                  sendtag: int = 0, recvtag: int = ANY_TAG,
                  comm: Optional[Communicator] = None):
    """MPI-4 nonblocking combined send+receive; the request completes
    with the received payload."""
    return _call(comm, "isendrecv", sendobj, dest, source, sendtag, recvtag)


def MPI_Isendrecv_replace(buf: Any, dest: int, source: int = ANY_SOURCE,
                          sendtag: int = 0, recvtag: int = ANY_TAG,
                          comm: Optional[Communicator] = None):
    """MPI-4 nonblocking sendrecv_replace: tensor ``buf`` is refilled in
    place when the request completes."""
    return _call(comm, "isendrecv_replace", buf, dest, source, sendtag,
                 recvtag)


def MPI_Bcast(obj: Any, root: int = 0, comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "bcast", obj, root)


def MPI_Reduce(obj: Any, op: ops.ReduceOp = ops.SUM, root: int = 0,
               comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "reduce", obj, op, root)


def MPI_Allreduce(obj: Any, op: ops.ReduceOp = ops.SUM, algorithm: str = "auto",
                  comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "allreduce", obj, op, algorithm)


def MPI_Allgather(obj: Any, comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "allgather", obj)


def MPI_Alltoall(objs: Sequence[Any], comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "alltoall", objs)


def MPI_Barrier(comm: Optional[Communicator] = None) -> None:
    return _call(comm, "barrier")  # None, or ErrorCode under ERRORS_RETURN


def MPI_Comm_split(color: Optional[int], key: int = 0,
                   comm: Optional[Communicator] = None) -> Optional[Communicator]:
    return _call(comm, "split", color, key)


def MPI_Comm_dup(comm: Optional[Communicator] = None) -> Communicator:
    return _call(comm, "dup")


def MPI_Scatter(objs: Optional[Sequence[Any]], root: int = 0,
                comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "scatter", objs, root)


def MPI_Gather(obj: Any, root: int = 0, comm: Optional[Communicator] = None) -> Any:
    """Rooted gather: the list of payloads on ``root`` (a stacked tensor
    where every payload is a tensor of one shape), None elsewhere."""
    return _call(comm, "gather", obj, root)


def MPI_Isend(obj: Any, dest: int, tag: int = 0,
              comm: Optional[Communicator] = None):
    return _call(comm, "isend", obj, dest, tag)


def MPI_Irecv(source: int = ANY_SOURCE, tag: int = ANY_TAG,
              comm: Optional[Communicator] = None):
    return _call(comm, "irecv", source, tag)


def MPI_Wait(request) -> Any:
    return request.wait()


def MPI_Test(request):
    return request.test()


def MPI_Waitall(requests) -> list:
    return [r.wait() for r in requests]


def _retired(r) -> bool:
    return getattr(r, "_retired", False)


def MPI_Waitany(requests):
    """Block until some request completes; returns (index, value).

    MPI sets completed requests to MPI_REQUEST_NULL so the next Waitany
    moves on; the analogue here: a request RETURNED by Waitany/Waitsome/
    Testany is marked retired and skipped by later calls on the same set
    — a ``for _ in range(len(reqs)): MPI_Waitany(reqs)`` drain loop visits
    every request exactly once.  When every request is retired, returns
    (None, None) (MPI_UNDEFINED).

    Implementation: round-robin test() polling (the transports complete
    in background threads), with the inter-sweep sleep backing off to
    1ms — i.e. at most ~1000 sweeps/s while nothing is ready.  A poll
    loop is the honest Waitany over independent requests: blocking on
    any single request could miss an earlier completion on another."""
    import time as _time

    if not requests:
        raise ValueError("MPI_Waitany needs at least one request")
    # Scope the progress engine's stalled-poll publication to THIS
    # call's request list: when the verifier publishes on the drain
    # loop's behalf, the OR-set names exactly these requests' pending
    # sources, not the union over every posted request in the world.
    eng = None
    for r in requests:
        c = getattr(r, "_comm", None)
        if c is not None:
            eng = getattr(c._t, "_progress_engine", None)
            break
    prev_scope = eng.enter_poll_scope(requests) if eng is not None else None
    try:
        delay = 0.0
        while True:
            live = False
            for i, r in enumerate(requests):
                if _retired(r):
                    continue
                live = True
                done, value = r.test()
                if done:
                    r._retired = True
                    return i, value
            if not live:
                return None, None  # MPI_UNDEFINED: no active requests
            _time.sleep(delay)
            delay = min(0.001, delay + 0.0001)
    finally:
        if eng is not None:
            eng.exit_poll_scope(prev_scope)


def MPI_Waitsome(requests):
    """Block until at least one un-retired request completes; returns
    (indices, values) of ALL requests complete at that moment, retiring
    them (see MPI_Waitany).  ``(None, None)`` when nothing is active."""
    i0, v0 = MPI_Waitany(requests)
    if i0 is None:
        return None, None
    idx, vals = [i0], [v0]
    for i, r in enumerate(requests):
        if i == i0 or _retired(r):
            continue
        done, value = r.test()
        if done:
            r._retired = True
            idx.append(i)
            vals.append(value)
    order = sorted(range(len(idx)), key=lambda k: idx[k])
    return [idx[k] for k in order], [vals[k] for k in order]


def MPI_Testall(requests):
    """(all_done, values) — values is None unless every request is done
    (matching MPI's flag semantics).  Completed requests keep their value
    across re-polls (and Testall does NOT retire anything: its contract
    is a snapshot of the whole set, repeatable by design)."""
    results = [r.test() for r in requests]
    if all(done for done, _ in results):
        return True, [v for _, v in results]
    return False, None


def MPI_Testany(requests):
    """(done, index, value) of the first completed un-retired request
    (which it retires, see MPI_Waitany), else (False, None, None)."""
    for i, r in enumerate(requests):
        if _retired(r):
            continue
        done, value = r.test()
        if done:
            r._retired = True
            return True, i, value
    return False, None, None


def MPI_Probe(source: int = ANY_SOURCE, tag: int = ANY_TAG,
              comm: Optional[Communicator] = None, status=None) -> None:
    return _call(comm, "probe", source, tag, status)


def MPI_Iprobe(source: int = ANY_SOURCE, tag: int = ANY_TAG,
               comm: Optional[Communicator] = None, status=None) -> bool:
    return _call(comm, "iprobe", source, tag, status)


def MPI_Wtime() -> float:
    import time

    return time.perf_counter()


def MPI_Scan(obj: Any, op: ops.ReduceOp = ops.SUM,
             comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "scan", obj, op)


def MPI_Reduce_scatter(blocks: Any, op: ops.ReduceOp = ops.SUM,
                       comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "reduce_scatter", blocks, op)


def MPI_Exscan(obj: Any, op: ops.ReduceOp = ops.SUM,
               comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "exscan", obj, op)


def MPI_Allgatherv(obj: Any, counts: Sequence[int],
                   comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "allgatherv", obj, counts)


def MPI_Gatherv(obj: Any, counts: Sequence[int], root: int = 0,
                comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "gatherv", obj, counts, root)


def MPI_Scatterv(obj: Any, counts: Sequence[int], root: int = 0,
                 comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "scatterv", obj, counts, root)


def MPI_Alltoallv(blocks: Any, counts: Sequence[Sequence[int]],
                  comm: Optional[Communicator] = None) -> Any:
    return _call(comm, "alltoallv", blocks, counts)


def MPI_Maxloc(obj: Any, comm: Optional[Communicator] = None):
    """Allreduce with MPI_MAXLOC semantics: (max value, lowest rank with it)."""
    return _call(comm, "maxloc", obj)


def MPI_Minloc(obj: Any, comm: Optional[Communicator] = None):
    """Allreduce with MPI_MINLOC semantics: (min value, lowest rank with it)."""
    return _call(comm, "minloc", obj)


def MPI_Cart_create(dims: Sequence[int], periods: Optional[Sequence[bool]] = None,
                    comm: Optional[Communicator] = None):
    from .topology import cart_create

    return cart_create(_world(comm), dims, periods)


def MPI_Intercomm_create(group_a, group_b,
                         comm: Optional[Communicator] = None):
    """Two-group intercommunicator from explicit disjoint parent-rank
    groups (the host-side spelling of the leader/bridge protocol — see
    intercomm.py); returns None on non-member ranks."""
    from .intercomm import create_intercomm

    return create_intercomm(_world(comm), group_a, group_b)


def MPI_Intercomm_merge(intercomm, high: bool = False):
    return intercomm.merge(high)


def MPI_Comm_remote_size(intercomm) -> int:
    return intercomm.remote_size


def MPI_Comm_test_inter(comm) -> bool:
    return getattr(comm, "is_inter", False)


def MPI_Graph_create(edges, comm: Optional[Communicator] = None):
    """Arbitrary directed process graph from the global edge list [S]."""
    from .topology import graph_create

    return graph_create(_world(comm), edges)


def MPI_Dist_graph_create_adjacent(sources, destinations,
                                   comm: Optional[Communicator] = None):
    from .topology import dist_graph_create_adjacent

    return dist_graph_create_adjacent(_world(comm), sources, destinations)


def MPI_Dims_create(nnodes: int, ndims: int) -> list:
    from .topology import dims_create

    return dims_create(nnodes, ndims)


def MPI_Cart_coords(cart, rank: int):
    return cart.coords_of(rank)


def MPI_Cart_rank(cart, coords: Sequence[int]):
    return cart.rank_of(coords)


def MPI_Cart_shift(cart, direction: int, disp: int = 1):
    return cart.shift(direction, disp)


def MPI_Cart_sub(cart, remain_dims: Sequence[bool]):
    return cart.sub(remain_dims)


def MPI_Comm_group(comm: Optional[Communicator] = None):
    return _world(comm).group()


def MPI_Comm_create(group, comm: Optional[Communicator] = None):
    return _world(comm).create(group)


# MPI-3 spells the non-collective-over-comm variant MPI_Comm_create_group;
# our create() is already group-collective-only in spirit, so they coincide.
MPI_Comm_create_group = MPI_Comm_create


def MPI_Group_incl(group, positions: Sequence[int]):
    return group.incl(positions)


def MPI_Group_excl(group, positions: Sequence[int]):
    return group.excl(positions)


def MPI_Group_union(a, b):
    return a.union(b)


def MPI_Group_intersection(a, b):
    return a.intersection(b)


def MPI_Group_difference(a, b):
    return a.difference(b)


def MPI_Group_size(group) -> int:
    return group.size


def MPI_Group_rank(group, comm: Optional[Communicator] = None):
    """This process's position in ``group`` (None = MPI_UNDEFINED)."""
    return group.rank_of(_world(comm).rank)


def MPI_Group_translate_ranks(group, positions: Sequence[int], other):
    return group.translate(positions, other)


# -- one-sided (RMA) -------------------------------------------------------


def MPI_Win_create(init: Any, comm: Optional[Communicator] = None):
    """Expose ``init`` (copied) as this rank's RMA window [S: MPI-2]."""
    return _world(comm).win_create(init)


def MPI_Win_fence(win) -> None:
    win.fence()


def MPI_Put(win, data: Any, target, loc: Any = None) -> None:
    win.put(data, target, loc=loc)


def MPI_Get(win, target, fill: Any = 0, loc: Any = None):
    """Returns a GetFuture; ``.value`` is defined after the closing fence.
    ``fill`` resolves ranks with no source in a pattern-form get."""
    return win.get(target, fill=fill, loc=loc)


def MPI_Accumulate(win, data: Any, target, op=ops.SUM, loc: Any = None) -> None:
    win.accumulate(data, target, op=op, loc=loc)


def MPI_Win_lock(win, rank: int, exclusive: bool = True) -> None:
    """MPI_Win_lock [S]: passive-target epoch (process backends)."""
    win.lock(rank, exclusive)


def MPI_Win_unlock(win, rank: int) -> None:
    win.unlock(rank)


def MPI_Win_free(win) -> None:
    win.free()


# -- neighborhood collectives ----------------------------------------------


def MPI_Neighbor_allgather(cart, obj: Any, fill: Any = None):
    return cart.neighbor_allgather(obj, fill=fill)


def MPI_Neighbor_alltoall(cart, objs: Sequence[Any], fill: Any = None):
    return cart.neighbor_alltoall(objs, fill=fill)


# -- persistent requests ---------------------------------------------------


def MPI_Send_init(buf: Any, dest: int, tag: int = 0,
                  comm: Optional[Communicator] = None):
    return _call(comm, "send_init", buf, dest, tag)


def MPI_Recv_init(source: int = ANY_SOURCE, tag: int = ANY_TAG,
                  buf: Any = None, comm: Optional[Communicator] = None):
    return _call(comm, "recv_init", source, tag, buf=buf)


def MPI_Start(request):
    return request.start()


def MPI_Startall(requests: Sequence[Any]):
    from .communicator import startall

    return startall(requests)


# -- nonblocking collectives [S: MPI-3] ------------------------------------


def MPI_Ibcast(obj: Any, root: int = 0, comm: Optional[Communicator] = None):
    return _call(comm, "ibcast", obj, root)


def MPI_Ireduce(obj: Any, op=ops.SUM, root: int = 0,
                comm: Optional[Communicator] = None):
    return _call(comm, "ireduce", obj, op, root)


def MPI_Iallreduce(obj: Any, op=ops.SUM, algorithm: str = "auto",
                   comm: Optional[Communicator] = None):
    return _call(comm, "iallreduce", obj, op, algorithm)


def MPI_Iallgather(obj: Any, comm: Optional[Communicator] = None):
    return _call(comm, "iallgather", obj)


def MPI_Ialltoall(objs: Sequence[Any], comm: Optional[Communicator] = None):
    return _call(comm, "ialltoall", objs)


def MPI_Ibarrier(comm: Optional[Communicator] = None):
    return _call(comm, "ibarrier")


def MPI_Iscatter(objs, root: int = 0, comm: Optional[Communicator] = None):
    return _call(comm, "iscatter", objs, root)


def MPI_Igather(obj: Any, root: int = 0, comm: Optional[Communicator] = None):
    return _call(comm, "igather", obj, root)


# -- environment inquiry & abort -------------------------------------------


def MPI_Get_processor_name() -> str:
    import socket

    return socket.gethostname()


def MPI_Get_version():
    """(major, minor) of the MPI standard this layer conforms to, the
    reference's answer: MPI-3.0.  The port has the point-to-point and
    collective layers, groups, topologies, derived datatypes, error
    handlers, attribute caching, COMM_SELF, RMA windows (fence, PSCW,
    passive target, atomics, shared and dynamic windows), nonblocking and
    neighborhood collectives, matched probes, ULFM and the MPI_T
    interface, MPI-IO with views, datareps and collective buffering, the
    dynamic processes (spawn, ports, the name service), and the MPI-4
    previews of ``mpi4.py``."""
    return (3, 0)


def MPI_Get_library_version() -> str:
    from . import __version__

    return (f"mpi_tpu_torch {__version__} (PyTorch/CUDA: hand-written "
            f"Hopper kernels + local/socket/shm process transports)")


def MPI_Abort(code: int = 1, comm: Optional[Communicator] = None) -> None:
    """Terminate this rank immediately with ``code``; under the launcher
    the nonzero exit propagates and the remaining ranks are killed (the
    launcher's kill-all contract)."""
    import os
    import sys

    sys.stderr.write(f"MPI_Abort(code={code})\n")
    sys.stderr.flush()
    os._exit(code)


def MPI_Wtick() -> float:
    import time

    return time.get_clock_info("perf_counter").resolution


def MPI_Sendrecv_replace(obj: Any, dest: int, source: int = ANY_SOURCE,
                         sendtag: int = 0, recvtag: int = ANY_TAG,
                         comm: Optional[Communicator] = None):
    """MPI_Sendrecv_replace [S]: same buffer for send and receive — in this
    library's value semantics, simply returns the received payload."""
    return _call(comm, "sendrecv", obj, dest, source, sendtag, recvtag)


# -- derived datatypes (MPI-1 ch.3; datatypes.py) ----------------------------

MPI_Type_contiguous = datatypes.type_contiguous
MPI_Type_vector = datatypes.type_vector
MPI_Type_indexed = datatypes.type_indexed
MPI_Type_create_subarray = datatypes.type_create_subarray
MPI_Type_create_struct = datatypes.type_create_struct
MPI_Type_create_resized = datatypes.type_create_resized
MPI_Pack = datatypes.pack
MPI_Pack_external = datatypes.pack_external
MPI_Unpack_external = datatypes.unpack_external
MPI_Unpack = datatypes.unpack
MPI_Pack_size = datatypes.pack_size
Datatype = datatypes.Datatype


def MPI_Type_commit(datatype: datatypes.Datatype) -> datatypes.Datatype:
    return datatype.commit()


def MPI_Type_free(datatype: datatypes.Datatype) -> None:
    datatype.free()


def MPI_Type_size(datatype: datatypes.Datatype) -> int:
    return datatype.size


def MPI_Type_get_extent(datatype: datatypes.Datatype):
    """(lower bound, extent) in bytes."""
    return (datatype.lb * datatype.base_dtype.itemsize, datatype.extent_bytes)


def MPI_COMM_SELF() -> Communicator:
    """The size-1 communicator containing only this process [S]."""
    from . import comm_self

    return comm_self()


def _datatype_bytes(datatype) -> int:
    if isinstance(datatype, datatypes.Datatype):
        return datatype.size
    if isinstance(datatype, torch.dtype):
        return datatype.itemsize
    return np.dtype(datatype).itemsize


def MPI_Get_count(status: Status, datatype) -> Optional[int]:
    """Instances of ``datatype`` in the received payload; None
    (MPI_UNDEFINED) when the payload was an opaque object, the status
    came from a probe (envelope only), or the size is not a whole
    multiple of the datatype.  ``datatype`` is a Datatype, a torch dtype
    or numpy dtype-like."""
    nbytes = _datatype_bytes(datatype)
    if status.count_bytes is None or nbytes == 0 or \
            status.count_bytes % nbytes:
        return None
    return status.count_bytes // nbytes


def MPI_Get_elements(status: Status, datatype) -> Optional[int]:
    """Base-element count of the received payload (MPI_Get_elements:
    counts primitive elements even when a partial instance arrived)."""
    if isinstance(datatype, datatypes.Datatype):
        item = datatype.base_dtype.itemsize
    else:
        item = _datatype_bytes(datatype)
    if status.count_bytes is None or item == 0 or status.count_bytes % item:
        return None
    return status.count_bytes // item


# -- error handling (MPI-1 ch.7; errors.py) ---------------------------------

MPI_SUCCESS = errors.MPI_SUCCESS
MPI_ERRORS_ARE_FATAL = errors.ERRORS_ARE_FATAL
MPI_ERRORS_RETURN = errors.ERRORS_RETURN
MPI_Error_class = errors.error_class
MPI_Error_string = errors.error_string
ErrorCode = errors.ErrorCode


def MPI_Comm_set_errhandler(handler, comm: Optional[Communicator] = None) -> None:
    """ERRORS_ARE_FATAL (default), ERRORS_RETURN, or ``handler(comm, exc)``."""
    _world(comm).set_errhandler(handler)


def MPI_Comm_get_errhandler(comm: Optional[Communicator] = None):
    return _world(comm).get_errhandler()


def MPI_Errhandler_create(fn):
    """MPI_Errhandler_create: any ``fn(comm, exc)`` callable IS a handler."""
    return fn


# -- fault tolerance (ULFM proposal; ft.py) ----------------------------------

MPI_ERR_PROC_FAILED = errors.MPI_ERR_PROC_FAILED
MPI_ERR_REVOKED = errors.MPI_ERR_REVOKED


def MPIX_Comm_revoke(comm: Optional[Communicator] = None):
    """Revoke the communicator everywhere (not collective): every rank's
    pending and future operations on it raise RevokedError /
    MPI_ERR_REVOKED — the survivor-unblocking half of the failure story."""
    return _call(comm, "revoke")


def MPIX_Comm_shrink(comm: Optional[Communicator] = None):
    """Survivors agree on the failed set and return a dense
    sub-communicator of them (collective among survivors; valid on a
    revoked communicator)."""
    return _call(comm, "shrink")


def MPIX_Comm_agree(value: bool = True,
                    comm: Optional[Communicator] = None):
    """Fault-tolerant agreement on the AND of every live rank's value;
    ERR_PROC_FAILED (after agreeing) while dead members are
    unacknowledged."""
    return _call(comm, "agree", value)


def MPIX_Comm_failure_ack(comm: Optional[Communicator] = None):
    """Acknowledge all currently known failures (re-arms ANY_SOURCE
    receives and agreement); returns the acknowledged ranks."""
    return _call(comm, "failure_ack")


def MPIX_Comm_failure_get_acked(comm: Optional[Communicator] = None):
    return _call(comm, "failure_get_acked")


def MPIX_Comm_get_failed(comm: Optional[Communicator] = None):
    """Comm ranks this process currently believes dead (sorted)."""
    return _call(comm, "get_failed")


# -- elastic membership (membership.py) --------------------------------------


def MPIX_Comm_accept_rejoin(comm: Optional[Communicator] = None,
                            timeout: Optional[float] = None):
    """Survivor-side grow-back (collective on the SHRUNKEN
    communicator): announce the vacant world slots under the post-shrink
    membership epoch, admit replacement claims (refusing an
    ousted-but-live incarnation until failure_ack), and return the
    full-size communicator under the new epoch."""
    return _call(comm, "accept_rejoin", timeout=timeout)


def MPIX_Comm_rejoin(rdv_dir: Optional[str] = None,
                     timeout: Optional[float] = None, **kwargs):
    """Joiner-side grow-back, from a FRESH process (no communicator
    yet): claim a vacant slot from the newest vacancy announcement on
    the rendezvous dir and return the full-size world communicator
    under the announced epoch (membership.rejoin)."""
    from . import membership

    return membership.rejoin(rdv_dir=rdv_dir, timeout=timeout, **kwargs)


def MPIX_Comm_get_epoch(comm: Optional[Communicator] = None) -> int:
    """The communicator's monotone membership epoch (0 at world
    creation; bumped by every shrink / healing transition)."""
    return _world(comm).membership_epoch


# -- attribute caching (MPI-1 ch.5.7 keyvals) -------------------------------

MPI_Comm_create_keyval = _comm.create_keyval
MPI_COMM_DUP_FN = _comm.dup_fn
MPI_COMM_NULL_COPY_FN = None
MPI_NO_COPY = _comm.NO_COPY
Keyval = _comm.Keyval


def MPI_Comm_free_keyval(keyval) -> None:
    """The keyval object is the handle; freeing is garbage collection."""


def MPI_Comm_set_attr(keyval, value, comm: Optional[Communicator] = None) -> None:
    _world(comm).set_attr(keyval, value)


def MPI_Comm_get_attr(keyval, comm: Optional[Communicator] = None):
    return _world(comm).get_attr(keyval)


def MPI_Comm_delete_attr(keyval, comm: Optional[Communicator] = None) -> None:
    _world(comm).delete_attr(keyval)


# -- dynamic process management (MPI-2 ch.5; mpi_tpu_torch/spawn.py) --------------


def MPI_Comm_spawn(command: Sequence[str], maxprocs: int, root: int = 0,
                   comm: Optional[Communicator] = None, info=None):
    """Spawn ``maxprocs`` ranks of ``python command...`` as a new world;
    returns the parent-child intercommunicator."""
    from .spawn import comm_spawn

    return comm_spawn(command, maxprocs, comm, root, info=info)


def MPI_Comm_spawn_multiple(segments, root: int = 0,
                            comm: Optional[Communicator] = None):
    from .spawn import comm_spawn_multiple

    return comm_spawn_multiple(segments, comm, root)


def MPI_Comm_get_parent():
    from .spawn import comm_get_parent

    return comm_get_parent()


def MPI_Open_port() -> str:
    from .spawn import open_port

    return open_port()


def MPI_Close_port(port_name: str) -> None:
    from .spawn import close_port

    close_port(port_name)


def MPI_Comm_accept(port_name: str, root: int = 0,
                    comm: Optional[Communicator] = None):
    from .spawn import comm_accept

    return comm_accept(port_name, comm, root)


def MPI_Comm_connect(port_name: str, root: int = 0,
                     comm: Optional[Communicator] = None):
    from .spawn import comm_connect

    return comm_connect(port_name, comm, root)


def MPI_Publish_name(service_name: str, port_name: str) -> None:
    from .spawn import publish_name

    publish_name(service_name, port_name)


def MPI_Unpublish_name(service_name: str) -> None:
    from .spawn import unpublish_name

    unpublish_name(service_name)


def MPI_Lookup_name(service_name: str) -> str:
    from .spawn import lookup_name

    return lookup_name(service_name)


# -- MPI-IO (MPI-2 ch.9; mpi_tpu_torch/io.py) -------------------------------------

from . import io as _io  # noqa: E402 - grouped with its API block

MPI_MODE_RDONLY = _io.MODE_RDONLY
MPI_MODE_WRONLY = _io.MODE_WRONLY
MPI_MODE_RDWR = _io.MODE_RDWR
MPI_MODE_CREATE = _io.MODE_CREATE
MPI_MODE_EXCL = _io.MODE_EXCL
MPI_MODE_APPEND = _io.MODE_APPEND
MPI_MODE_DELETE_ON_CLOSE = _io.MODE_DELETE_ON_CLOSE
MPI_SEEK_SET, MPI_SEEK_CUR, MPI_SEEK_END = _io.SEEK_SET, _io.SEEK_CUR, _io.SEEK_END
MPI_File_delete = _io.file_delete


def MPI_File_open(path: str, amode: int = _io.MODE_RDWR,
                  comm: Optional[Communicator] = None,
                  shared: bool = False, info=None) -> "_io.File":
    return _io.file_open(_world(comm), path, amode, shared, info)


def MPI_File_close(fh: "_io.File") -> None:
    fh.close()


def MPI_File_read_at(fh, offset: int, count: int):
    return fh.read_at(offset, count)


def MPI_File_write_at(fh, offset: int, data: Any) -> int:
    return fh.write_at(offset, data)


def MPI_File_read_at_all(fh, offset: int, count: int):
    return fh.read_at_all(offset, count)


def MPI_File_write_at_all(fh, offset: int, data: Any) -> int:
    return fh.write_at_all(offset, data)


def MPI_File_seek(fh, offset: int, whence: int = _io.SEEK_SET) -> None:
    fh.seek(offset, whence)


def MPI_File_get_position(fh) -> int:
    return fh.get_position()


def MPI_File_read(fh, count: int):
    return fh.read(count)


def MPI_File_write(fh, data: Any) -> int:
    return fh.write(data)


def MPI_File_read_shared(fh, count: int):
    return fh.read_shared(count)


def MPI_File_write_shared(fh, data: Any) -> int:
    return fh.write_shared(data)


def MPI_File_seek_shared(fh, offset: int) -> None:
    fh.seek_shared(offset)


def MPI_File_set_view(fh, disp: int = 0, etype: Any = None,
                      filetype=None, datarep: str = "native") -> None:
    fh.set_view(disp, etype if etype is not None else np.uint8, filetype,
                datarep)


def MPI_Register_datarep(datarep: str, read_conversion_fn,
                         write_conversion_fn, dtype_file_extent_fn=None,
                         extra_state=None) -> None:
    """Register a user file-data representation for MPI_File_set_view
    (callback shapes: mpi_tpu_torch/io.py Datarep)."""
    _io.register_datarep(datarep, read_conversion_fn, write_conversion_fn,
                         dtype_file_extent_fn, extra_state)


def MPI_File_get_view(fh):
    return fh.get_view()


def MPI_File_get_size(fh) -> int:
    return fh.get_size()


def MPI_File_set_size(fh, size: int) -> None:
    fh.set_size(size)


def MPI_File_preallocate(fh, size: int) -> None:
    fh.preallocate(size)


def MPI_File_sync(fh) -> None:
    fh.sync()


def MPI_File_write_ordered(fh, data: Any) -> int:
    return fh.write_ordered(data)


def MPI_File_read_ordered(fh, count: int):
    return fh.read_ordered(count)


# -- Info objects (MPI-2) ----------------------------------------------------
# An Info is a string-keyed hint dictionary; this library's spelling IS a
# dict (the docstring of MPI_Get_version used to name this as the gap).

class Info(dict):
    """MPI_Info: string key/value hints (advisory); exists so MPI-2 code
    ports without surgery."""


MPI_INFO_NULL = None


def MPI_Info_create() -> Info:
    return Info()


def MPI_Info_set(info: Info, key: str, value: str) -> None:
    info[str(key)] = str(value)


def MPI_Info_get(info: Info, key: str, default: Optional[str] = None):
    return info.get(key, default)


def MPI_Info_delete(info: Info, key: str) -> None:
    info.pop(key, None)


def MPI_Info_dup(info: Info) -> Info:
    return Info(info)


def MPI_Info_free(info: Info) -> None:
    info.clear()


def MPI_Info_get_nkeys(info: Info) -> int:
    return len(info)


def MPI_Mprobe(source: int = ANY_SOURCE, tag: int = ANY_TAG,
               comm: Optional[Communicator] = None,
               status: Optional[Status] = None):
    """Matched probe (MPI-3): returns an MPI_Message no other receive can
    steal; consume with MPI_Mrecv."""
    return _call(comm, "mprobe", source, tag, status)


def MPI_Improbe(source: int = ANY_SOURCE, tag: int = ANY_TAG,
                comm: Optional[Communicator] = None,
                status: Optional[Status] = None):
    return _call(comm, "improbe", source, tag, status)


def MPI_Mrecv(message, status: Optional[Status] = None):
    try:
        return message.recv(status)
    except Exception as exc:  # noqa: BLE001 - same boundary as every MPI_*
        c = getattr(message, "_comm", None)
        if c is None:
            raise
        return errors.invoke_handler(c, exc)


def MPI_Win_allocate_shared(nelems: int, dtype=None,
                            comm: Optional[Communicator] = None):
    """Collectively allocate a host-shared load/store window; query
    any rank's region with win.remote(rank) (MPI_Win_shared_query)."""
    from .shmwin import win_allocate_shared

    return win_allocate_shared(comm, nelems,
                               dtype if dtype is not None else torch.float64)


def MPI_Win_shared_query(win, rank: int):
    """(size_in_elements, the live shared view) of ``rank``'s region."""
    view = win.remote(rank)
    return view.numel(), view


def MPI_Win_sync(win) -> None:
    win.sync()


def MPI_Win_post(win, group) -> None:
    """PSCW exposure epoch: expose ``win`` to origin ranks ``group``."""
    win.post(group)


def MPI_Win_start(win, group) -> None:
    win.start(group)


def MPI_Win_complete(win) -> None:
    win.complete()


def MPI_Win_wait(win) -> None:
    win.wait()


def MPI_Win_test(win) -> bool:
    return win.test()


def MPI_Fetch_and_op(win, data: Any, target: int, op=ops.SUM, loc: Any = None):
    """MPI-3 atomic: combine ``data`` into the target window, return the
    previous value (one round-trip; the distributed-counter primitive)."""
    return win.fetch_and_op(target, data, op, loc)


def MPI_Compare_and_swap(win, compare: Any, new: Any, target: int,
                         loc: Any = None):
    return win.compare_and_swap(target, compare, new, loc)


def MPI_Win_flush(win, target: int) -> None:
    win.flush(target)


MPI_COMM_TYPE_SHARED = "shared"


def MPI_Comm_split_type(split_type=MPI_COMM_TYPE_SHARED, key: int = 0,
                        comm: Optional[Communicator] = None):
    """MPI_Comm_split_type(COMM_TYPE_SHARED): ranks that share memory.
    Process worlds are single-host (the launcher forks locally), so it is
    the whole communicator reordered by key."""
    return _call(comm, "split_type", split_type, key)


MPI_Type_create_hvector = datatypes.type_create_hvector
MPI_Type_create_hindexed = datatypes.type_create_hindexed


def MPI_Win_lock_all(win) -> None:
    win.lock_all()


def MPI_Win_unlock_all(win) -> None:
    win.unlock_all()


def MPI_Win_flush_all(win) -> None:
    win.flush_all()


def MPI_Win_flush_local(win, target: int) -> None:
    win.flush_local(target)


def MPI_Get_accumulate(win, data: Any, target: int, op=ops.SUM,
                       loc: Any = None):
    return win.get_accumulate(target, data, op, loc)


def MPI_Rput(win, data: Any, target: int, loc: Any = None):
    return win.rput(target, data, loc)


def MPI_Rget(win, target: int, loc: Any = None):
    return win.rget(target, loc)


def MPI_Raccumulate(win, data: Any, target: int, op=ops.SUM,
                    loc: Any = None):
    return win.raccumulate(target, data, op, loc)


def MPI_Comm_idup(comm: Optional[Communicator] = None):
    """MPI_Comm_idup: dup is synchronous here, so the request completes
    at creation carrying the new communicator."""
    from .communicator import _CompletedRequest

    return _CompletedRequest(_world(comm).dup())


# -- MPI-4 previews (mpi4.py) ------------------------------------------------


def MPI_Bcast_init(obj: Any, root: int = 0,
                   comm: Optional[Communicator] = None):
    from .mpi4 import persistent_collective

    return persistent_collective(_world(comm), "bcast", obj, root)


def MPI_Allreduce_init(obj: Any, op=ops.SUM,
                       comm: Optional[Communicator] = None):
    from .mpi4 import persistent_collective

    return persistent_collective(_world(comm), "allreduce", obj, op)


def MPI_Reduce_init(obj: Any, op=ops.SUM, root: int = 0,
                    comm: Optional[Communicator] = None):
    from .mpi4 import persistent_collective

    return persistent_collective(_world(comm), "reduce", obj, op, root)


def MPI_Allgather_init(obj: Any, comm: Optional[Communicator] = None):
    from .mpi4 import persistent_collective

    return persistent_collective(_world(comm), "allgather", obj)


def MPI_Alltoall_init(objs: Any, comm: Optional[Communicator] = None):
    from .mpi4 import persistent_collective

    return persistent_collective(_world(comm), "alltoall", objs)


def MPI_Reduce_scatter_init(blocks: Any, op=ops.SUM,
                            comm: Optional[Communicator] = None):
    from .mpi4 import persistent_collective

    return persistent_collective(_world(comm), "reduce_scatter", blocks, op)


def MPI_Barrier_init(comm: Optional[Communicator] = None):
    from .mpi4 import persistent_collective

    return persistent_collective(_world(comm), "barrier")


def MPI_Psend_init(buf: Any, partitions: int, dest: int, tag: int = 0,
                   comm: Optional[Communicator] = None):
    from .mpi4 import psend_init

    return psend_init(_world(comm), buf, partitions, dest, tag)


def MPI_Precv_init(partitions: int, source: int, tag: int = 0,
                   comm: Optional[Communicator] = None):
    from .mpi4 import precv_init

    return precv_init(_world(comm), partitions, source, tag)


def MPI_Pready(request, partition: int) -> None:
    request.pready(partition)


def MPI_Pready_range(request, lo: int, hi: int) -> None:
    request.pready_range(lo, hi)


def MPI_Parrived(request, partition: int) -> bool:
    return request.parrived(partition)


# -- MPI-4 sessions (mpi4.py Session) ----------------------------------------


def MPI_Session_init(info: Optional[dict] = None, errhandler=None):
    from .mpi4 import session_init

    return session_init(info, errhandler)


def MPI_Session_finalize(session) -> None:
    session.finalize()


def MPI_Session_get_num_psets(session, info: Optional[dict] = None) -> int:
    return session.get_num_psets(info)


def MPI_Session_get_nth_pset(session, n: int,
                             info: Optional[dict] = None) -> str:
    return session.get_nth_pset(n, info)


def MPI_Session_get_info(session) -> dict:
    return session.get_info()


def MPI_Group_from_session_pset(session, pset_name: str):
    return session.group_from_pset(pset_name)


def MPI_Comm_create_from_group(group, stringtag: str = "",
                               info: Optional[dict] = None,
                               errhandler=None, session=None):
    """The group carries no session in this implementation's Group type,
    so the session is an explicit (keyword) argument; omitting it uses a
    fresh default-runtime session — the common spelling."""
    if session is None:
        from .mpi4 import session_init

        session = session_init()
    return session.comm_create_from_group(group, stringtag, info,
                                          errhandler)


def MPI_Win_create_dynamic(comm: Optional[Communicator] = None):
    return _world(comm).win_create_dynamic()


def MPI_Win_attach(win, key: str, array: Any):
    return win.attach(key, array)


def MPI_Win_detach(win, key: str):
    return win.detach(key)


# -- MPI_T tool interface (mpit.py) ------------------------------------------

from . import mpit as _mpit  # noqa: E402 - grouped with its API block

MPI_T_cvar_list = _mpit.cvar_list
MPI_T_cvar_read = _mpit.cvar_read
MPI_T_cvar_write = _mpit.cvar_write
MPI_T_pvar_list = _mpit.pvar_list
MPI_T_pvar_read = _mpit.pvar_read
MPI_T_pvar_session_create = _mpit.session_create
