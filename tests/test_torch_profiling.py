"""Profiling helpers (``mpi_tpu_torch.profiling``) against the JAX
package's (``mpi_tpu/profiling.py``) on the CPU: ``timeit`` and
``CommStats`` as ``tests/test_aux.py:123-150`` checks them, through both
packages; ``trace`` writes a Chrome trace that ``json`` reads and
``trace_summary`` sums.  Counters and JSON are compared exactly; timings
only by their order (p10 <= p50 <= p90), since each run times anew.
"""

import dataclasses
import json

import numpy as np
import pytest

import torch

from mpi_tpu import profiling as jprof
from mpi_tpu_torch import profiling as prof


@pytest.mark.parametrize("module", [prof, jprof], ids=["port", "reference"])
def test_timeit_measures(module):
    """tests/test_aux.py:123."""
    t = module.timeit(lambda: sum(range(1000)), iters=10, warmup=2)
    assert t.p50_s > 0
    assert t.p10_s <= t.p50_s <= t.p90_s
    assert t.n == 10
    assert t.p50_us == t.p50_s * 1e6


def test_timing_has_the_reference_fields():
    assert [f.name for f in dataclasses.fields(prof.Timing)] == \
        [f.name for f in dataclasses.fields(jprof.Timing)]


def test_timeit_returns_after_torch_work():
    calls = []

    def fn():
        calls.append(1)
        return {"a": torch.ones(4) * 2, "b": [torch.zeros(2)], "c": 3}

    t = prof.timeit(fn, iters=4, warmup=1)
    assert t.n == 4 and len(calls) == 5


def test_comm_stats_json_matches_reference():
    """tests/test_aux.py:135, through both packages."""
    port, ref = prof.CommStats(), jprof.CommStats()
    for s in (port, ref):
        s.record("allreduce", 4096)
        s.record("allreduce", 4096)
        s.record("bcast", 128)
        s.record("barrier")
    assert port.to_json() == ref.to_json()
    data = json.loads(port.to_json())
    assert data == {"ops": {"allreduce": 2, "bcast": 1, "barrier": 1},
                    "bytes": {"allreduce": 8192, "bcast": 128, "barrier": 0}}


def test_trace_writes_a_readable_chrome_trace(tmp_path):
    """tests/test_aux.py:146 (``jax.profiler`` there, ``torch.profiler``
    here): the enclosed work shows in a Chrome trace under log_dir."""
    with prof.trace(str(tmp_path)):
        torch.arange(128.0).mul(2).sum()
    path = tmp_path / prof.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mul" in n for n in names), sorted(names)[:20]
    summary = prof.trace_summary(str(path))  # no card: no device work
    assert summary == {"busy_ms": 0.0, "span_ms": 0.0, "kernel_launches": 0,
                       "copies_and_fills": 0, "by_name": []}


def test_trace_summary_counts_overlapping_device_work_once(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},   # overlaps a
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 30, "dur": 4},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 40, "dur": 2},
        {"ph": "X", "cat": "gpu_memset", "name": "fill", "ts": 50, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0, "dur": 100},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = prof.trace_summary(str(path))
    assert s["kernel_launches"] == 3 and s["copies_and_fills"] == 2
    np.testing.assert_allclose([s["busy_ms"], s["span_ms"]], [0.022, 0.051])
    assert s["by_name"][0][0] in ("a", "b")
    assert {k: (round(ms, 6), c) for k, ms, c in s["by_name"]} == {
        "a": (0.012, 2), "b": (0.01, 1), "copy": (0.004, 1), "fill": (0.001, 1)}
