"""Ahead-of-time tracing of SPMD programs: the counterpart of the
reference's AOT path (``__graft_entry__.py:197 _jit_multichip``, ``jax.jit``
over an ``AbstractMesh`` and ``.lower`` / ``jax.export``).

``lower(fn, *avals)`` traces ``fn`` with ``make_fx(tracing_mode="fake")``
on fake tensors of the given shapes on the target device: no tensor is
allocated and no kernel is built or launched.  The target is the CUDA card
by default, and may be the card on a host that has none, as
``jax.export(platforms=["tpu"])`` targets a TPU from any host.  Every
kernel launch of the port is a ``torch.library`` op with a fake
implementation (``gpu/ring.py`` ``ring_fold``/``ring_gather``,
``gpu/attention.py`` ``attn_fwd``/``attn_bwd_dq``/``attn_bwd_dkv``), so
the graph holds one ``mpi_tpu_torch::<entry point>`` node per launch.

A trace for the card needs a PyTorch built with CUDA: a build for the CPU
only has no device guard for CUDA, which fake CUDA tensors need, and
``lower`` refuses it at once.  A program with a backward pass needs the
card itself, since the autograd engine asks the device runtime for its
stream even on fake tensors; ``lower`` says so.  ``export`` hands the
traced graph to ``torch.export``.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from .gpu.runner import resolve_device, run_spmd

KERNEL_OPS = ("ring_fold", "ring_gather", "attn_fwd", "attn_bwd_dq",
              "attn_bwd_dkv")


def _fake_inputs(mode: FakeTensorMode, avals: Sequence[Any],
                device: torch.device) -> List[torch.Tensor]:
    """Fake tensors on ``device`` for ``avals``: tensors (of any device,
    ``meta`` included) give their shape and dtype, tuples are float32
    shapes."""
    out = []
    with mode:
        for a in avals:
            shape, dtype = ((tuple(a.shape), a.dtype) if hasattr(a, "dtype")
                            else (tuple(a), torch.float32))
            out.append(torch.empty(shape, dtype=dtype, device=device))
    return out


def lower(fn: Callable, *avals: Any, device=None) -> torch.fx.GraphModule:
    """``fn(*tensors)`` traced on fake tensors of ``avals`` on ``device``
    (the card by default): the whole program as one aten-level graph,
    kernel launches included as ``mpi_tpu_torch::`` nodes.  Allocates no
    memory on the device."""
    dev = resolve_device(device, trace=True)
    if dev.type == "cuda" and torch.version.cuda is None:
        raise RuntimeError(
            "a trace for the card needs a PyTorch built with CUDA (fake CUDA "
            "tensors need its device guard); this one is built for the CPU "
            "only: trace for device='cpu' here, or for the card on the "
            "machine that has one")
    mode = FakeTensorMode()
    args = _fake_inputs(mode, avals, dev)
    try:
        return make_fx(fn, tracing_mode="fake")(*args)
    except RuntimeError as e:
        if dev.type == "cuda" and not torch.cuda.is_available() and \
                "accelerator" in str(e):
            raise RuntimeError(
                "a trace for the card of a program with a backward pass "
                "needs the card: the autograd engine asks the device runtime "
                "for its current stream, even on fake tensors") from e
        raise


def export(fn: Callable, *avals: Any, device=None):
    """``torch.export.export`` of ``lower(fn, *avals, device=device)``,
    with fake example inputs (nothing is allocated): an
    ``ExportedProgram`` that ``torch.export.save`` writes and
    ``torch.export.load`` reads back, kernel ops included."""
    dev = resolve_device(device, trace=True)
    graph = lower(fn, *avals, device=dev)
    mode = FakeTensorMode()
    args = _fake_inputs(mode, avals, dev)
    program = torch.export.export(graph, tuple(args), strict=False)
    # the fake example inputs would be written by ``torch.export.save`` and
    # refused by ``torch.export.load``; the signature keeps the shapes
    program.example_inputs = None
    return program


def lower_spmd(fn: Callable, *avals: Any, nranks: int = None, comm=None,
               device=None) -> torch.fx.GraphModule:
    """``lower`` of the SPMD program ``run_spmd(fn, *args, ...)``: the
    counterpart of lowering a ``shard_map`` over an ``AbstractMesh``."""
    dev = resolve_device(device, trace=True)
    return lower(lambda *a: run_spmd(fn, *a, nranks=nranks, comm=comm,
                                     device=dev), *avals, device=dev)


def kernel_nodes(graph_module: torch.fx.GraphModule) -> Dict[str, int]:
    """How many nodes of each kernel op the graph holds."""
    counts = collections.Counter()
    for node in graph_module.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if node.op == "call_function" and name.startswith("mpi_tpu_torch::"):
            op = name.split("::")[1].split(".")[0]
            if op in KERNEL_OPS:
                counts[op] += 1
    return dict(counts)
