"""run_spmd — execute a portable MPI program as one SPMD program over P
virtual ranks on one device.

Counterpart of ``mpi_tpu/tpu/runner.py`` (``default_mesh`` :98,
``run_spmd`` :134).  The reference maps ``fn`` over a mesh axis with
``jax.shard_map``; here ``fn`` runs under ``torch.vmap`` over a leading
rank dimension.  Arguments are replicated to every rank (``in_specs=P()``)
and each rank's results come back stacked ``[P, ...]`` in rank order.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch._guards import detect_fake_mode
from torch.utils import _pytree as pytree

from . import primitives
from .communicator import TorchCommunicator


def resolve_device(device=None, trace: bool = False) -> torch.device:
    """``None`` means the CUDA card; the CPU runs only when asked for.

    ``trace=True`` names the target of a trace on fake tensors, which runs
    nothing: there the card may be absent (``cuda:0`` stands for it), as
    ``jax.export`` targets a TPU from any host.  A run never takes it."""
    if device is None:
        if trace and not torch.cuda.is_available():
            return torch.device("cuda", 0)
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mpi_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        if trace:
            return torch.device("cuda", device.index or 0)
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def _tracing(args, kwargs) -> bool:
    """True while the arguments are fake tensors of a trace (``make_fx``
    with ``tracing_mode="fake"``, ``torch.export``): nothing runs then."""
    return detect_fake_mode(pytree.tree_leaves((args, kwargs))) is not None


def _to_device(a: Any, device: torch.device) -> Any:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if hasattr(a, "__array__") and not isinstance(a, (int, float, bool)):
        return torch.as_tensor(a, device=device)
    return a


def run_spmd(fn: Callable, *args: Any, nranks: Optional[int] = None,
             comm: Optional[TorchCommunicator] = None, device=None,
             **kwargs: Any):
    """Run ``fn(comm, *args, **kwargs)`` once per rank as one SPMD program.

    ``args`` (tensors, numpy arrays or Python values) are replicated to
    every rank; every leaf of ``fn``'s result comes back with a leading
    ``[nranks]`` dimension.  ``comm`` defaults to the world over
    ``nranks`` ranks; ``device`` defaults to the CUDA card."""
    if comm is None:
        if nranks is None:
            raise ValueError("run_spmd needs nranks (ranks are virtual on one "
                             "device) or a communicator")
        comm = TorchCommunicator(nranks)
    elif nranks is not None and nranks != comm._axis_size:
        raise ValueError(f"nranks={nranks} but comm spans {comm._axis_size} ranks")
    dev = resolve_device(device, trace=_tracing(args, kwargs))
    n = comm._axis_size
    args = tuple(_to_device(a, dev) for a in args)
    kwargs = {k: _to_device(v, dev) for k, v in kwargs.items()}

    def per_rank(idx):
        with primitives.world(idx, n, dev):
            res = fn(comm, *args, **kwargs)
        return pytree.tree_map(
            lambda r: r if r is None or isinstance(r, torch.Tensor)
            else primitives.host_table(r, dev), res)

    return torch.vmap(per_rank)(torch.arange(n, device=dev))
