"""Profiling helpers — copy of ``mpi_tpu/profiling.py:26-91`` for torch.

* :func:`trace` — context manager around ``torch.profiler`` (CPU and, on
  the card, CUDA activities) that writes a Chrome trace into ``log_dir``;
  :func:`trace_summary` reads one back.
* :func:`timeit` — wall-clock timing of a callable with a device fence
  per call (``torch.cuda.synchronize`` where it returned CUDA tensors),
  warm-up, median and percentiles.
* :class:`Timing` and :class:`CommStats`, copied as they are.

The reference's ``comm_stats`` reads the flight recorder of its telemetry
layer, which belongs to the host layer and is not ported yet.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import torch
from torch.utils import _pytree as pytree

TRACE_FILE = "trace.json"
# the device's own work in a Kineto Chrome trace: kernel launches, and the
# copies and fills the runtime does without a kernel of the program
KERNEL_CATEGORY = "kernel"
DEVICE_CATEGORIES = (KERNEL_CATEGORY, "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``log_dir/trace.json``; yields the profiler.  Records
    the CUDA activity too where a card is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def trace_summary(path: str) -> Dict[str, Any]:
    """What a Chrome trace written by :func:`trace` says of the device:
    the time its kernels, copies and fills ran (``busy_ms``, overlapping
    ones counted once), the span from the first one's start to the last
    one's end (``span_ms``), the count of kernel launches and, apart, of
    copies and fills, and each name's time and count, longest first
    (``by_name``).  All zero where the device did nothing (a CPU-only
    trace)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    launches = sum(e["cat"] == KERNEL_CATEGORY for e in device)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("name", "")) for e in device)
    busy_us, end_us, by_name = 0.0, None, {}
    for start, stop, name in spans:
        if end_us is None or start >= end_us:
            busy_us += stop - start
            end_us = stop
        elif stop > end_us:
            busy_us += stop - end_us
            end_us = stop
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (stop - start) / 1e3, count + 1)
    span_ms = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    return {"busy_ms": busy_us / 1e3, "span_ms": span_ms,
            "kernel_launches": launches, "copies_and_fills": len(device) - launches,
            "by_name": sorted(([n, ms, c] for n, (ms, c) in by_name.items()),
                              key=lambda r: -r[1])}


@dataclass
class Timing:
    p50_s: float
    p10_s: float
    p90_s: float
    n: int

    @property
    def p50_us(self) -> float:
        return self.p50_s * 1e6


def _fence(out: Any) -> None:
    """Wait for every CUDA device that ``out`` holds a tensor on (the
    counterpart of ``jax.block_until_ready``)."""
    devices = {t.device for t in pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


def timeit(fn: Callable[[], Any], iters: int = 50, warmup: int = 5) -> Timing:
    """Median wall-clock of ``fn()`` with a device fence per call: the
    card is synchronised after each call that returned CUDA tensors, so
    asynchronous launches don't fake the numbers."""

    def call():
        out = fn()
        _fence(out)
        return out

    for _ in range(warmup):
        call()
    samples: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    n = len(samples)
    return Timing(
        p50_s=statistics.median(samples),
        p10_s=samples[round(0.1 * (n - 1))],
        p90_s=samples[round(0.9 * (n - 1))],
        n=n,
    )


@dataclass
class CommStats:
    """Structured per-op counters (counts + bytes), JSON-able for logs."""

    ops: Dict[str, int] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)

    def record(self, op: str, nbytes: int = 0) -> None:
        self.ops[op] = self.ops.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0) + nbytes

    def to_json(self) -> str:
        return json.dumps({"ops": self.ops, "bytes": self.bytes})
