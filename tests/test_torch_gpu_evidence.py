"""The evidence writer's schema on a box without a card
(``mpi_tpu_torch/tools/gpu_evidence.py``, the counterpart of
``tools/tpu_evidence.py``): the standalone tool writes every section in
the reference's order; the card probe says ``ok: false`` with its reason
within its timeout; the card-gated sections say ``skipped`` with theirs;
every trace for the card records ``aot.lower``'s refusal on a PyTorch
built for the CPU only; the copied records are ``chip_smoke.py``'s,
bitwise; pytest's summary line parses to singular keys.  The same traces
for the CPU hold the plain version's products and no kernel node, which
shows that the trace's checks can fail.  The card's side of the tool is
``tests/test_torch_gpu_real.py::test_evidence_entry_and_traces_on_the_card``.
"""

import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from mpi_tpu_torch.tools import gpu_evidence as ge

ROOT = pathlib.Path(__file__).resolve().parents[1]
SECTIONS = ["generated", "command", "card", "gpu_tests", "entry_on_card", "export",
            "kernels", "launches_by_path"]
CHIP_SMOKE = {
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "kernels": [{"name": "ring_allreduce", "route": "cuda", "launches": 3,
                 "max_abs_err": 0.0, "ms": 1.25, "library_ms": None,
                 "launches_by_path": {"north-star data-parallel step": 1}}],
    "launches_by_path": {"north-star data-parallel step": {"ring_allreduce": 1}},
}
NO_CUDA_BUILD = "a trace for the card needs a PyTorch built with CUDA"


def _no_card():
    if torch.cuda.is_available() or torch.version.cuda is not None:
        pytest.skip("this box has a CUDA build: the card-gated sections run")


def test_standalone_record_has_every_section(tmp_path):
    _no_card()
    records = tmp_path / "chip_smoke.json"
    records.write_text(json.dumps(CHIP_SMOKE))
    out = tmp_path / "evidence.json"
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "mpi_tpu_torch.tools.gpu_evidence",
                        "--records", str(records), "--out", str(out)],
                       cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"wrote {out}" in r.stdout
    ev = json.loads(out.read_text())
    assert list(ev) == SECTIONS
    card = ev["card"]
    assert card["ok"] is False and "no CUDA device" in card["reason"]
    assert card["probe"] == "subprocess" and card["count"] == 0
    assert card["cuda"] is None and card["torch"] == torch.__version__
    assert "nvidia_smi" in card or "nvidia_smi_error" in card
    assert time.monotonic() - t0 < ge.PROBE_TIMEOUT_S
    for name in ("gpu_tests", "entry_on_card"):
        assert ev[name]["ok"] is False
        assert ev[name]["skipped"].startswith("no CUDA device"), ev[name]
    export = ev["export"]
    assert list(export) == [*ge.TRACES, "multichip_2d_pallas_ring", "ok", "seconds"]
    assert export["ok"] is False
    for name in (*ge.TRACES, "multichip_2d_pallas_ring"):
        assert export[name]["ok"] is False
        assert NO_CUDA_BUILD in export[name]["error"], export[name]
    assert ev["kernels"] == CHIP_SMOKE["kernels"]
    assert ev["launches_by_path"] == CHIP_SMOKE["launches_by_path"]


def test_without_records_every_section_stays():
    _no_card()
    ev = ge.collect(tier_skip="the card tier runs after chip_smoke.py", in_process=True)
    assert list(ev) == SECTIONS
    assert ev["card"]["probe"] == "in process" and ev["card"]["ok"] is False
    assert ev["gpu_tests"]["skipped"] == "the card tier runs after chip_smoke.py"
    for key in ("kernels", "launches_by_path"):
        assert ev[key] == {"ok": False,
                           "skipped": "no chip_smoke.py record given (--records)"}
    assert ge.summary(ev) == {k: False for k in SECTIONS[2:]}


def test_the_multichip_trace_is_copied_from_phase_6b():
    nodes = {"ring_fold": 1, "attn_fwd": 2}
    aot_rec = {"lower_kernel_nodes": {"ring": {"attn_fwd": 2}, "pallas_ring": nodes},
               "lower_s": 0.5}
    got = ge._multichip({"aot": aot_rec})
    assert got == {"ok": True, "from": "chip_smoke.py phase 6b", "kernel_nodes": nodes,
                   "record": aot_rec}
    bad = dict(aot_rec, lower_kernel_nodes={"pallas_ring": {"attn_fwd": 2}})
    assert ge._multichip({"aot": bad})["ok"] is False


def test_the_probe_is_bounded_by_its_timeout():
    t0 = time.monotonic()
    got = ge.probe_card(timeout=0.05)
    assert time.monotonic() - t0 < 30
    assert got == {"ok": False, "probe": "subprocess",
                   "reason": "the probe did not finish in 0.05 s"}


_TIER_ONE = """\
tests/test_torch_gpu_real.py .E                                           [100%]
==================================== ERRORS ====================================
____________ ERROR at setup of test_b ____________
E   RuntimeError: 3 passed in 0.1s is not a summary
=========================== short test summary info ============================
PASSED tests/test_torch_gpu_real.py::test_a
ERROR tests/test_torch_gpu_real.py::test_b - RuntimeError: boom
1 passed, 5 deselected, 1 error in 2.50s
"""

_TIER_TWO = """\
PASSED tests/test_torch_gpu_real.py::test_a[cuda]
PASSED tests/test_torch_gpu_real.py::test_c
ERROR tests/test_torch_gpu_real.py::test_b - RuntimeError: boom
ERROR tests/test_torch_gpu_real.py::test_d - RuntimeError: boom
FAILED tests/test_torch_gpu_real.py::test_e - AssertionError
SKIPPED tests/test_torch_gpu_real.py::test_f
========= 2 passed, 1 failed, 1 skipped, 2 errors, 1 warning in 3.10s ==========
"""


def test_tier_summary_keys_are_singular(tmp_path):
    one = ge.parse_tier(_TIER_ONE)
    assert one["summary"] == {"passed": 1, "deselected": 5, "error": 1}
    assert one["tests"] == {"tests/test_torch_gpu_real.py::test_a": "PASSED",
                            "tests/test_torch_gpu_real.py::test_b": "ERROR"}
    assert one["ok"] is False
    log = tmp_path / "gpu_tier.log"
    log.write_text(_TIER_TWO)
    two = ge.read_tier_log(str(log))
    assert two["summary"] == {"passed": 2, "failed": 1, "skipped": 1, "error": 2,
                              "warning": 1}
    assert set(one["summary"]) - {"deselected"} <= set(two["summary"])
    assert two["tests"]["tests/test_torch_gpu_real.py::test_a[cuda]"] == "PASSED"
    assert two["tests"]["tests/test_torch_gpu_real.py::test_f"] == "SKIPPED"
    assert two["log"] == str(log) and two["ok"] is False
    ok = ge.parse_tier("PASSED tests/test_torch_gpu_real.py::test_a\n"
                       "67 passed, 21 deselected in 133.60s (0:02:13)\n")
    assert ok["ok"] is True and ok["summary"] == {"passed": 67, "deselected": 21}


@pytest.mark.parametrize("name", ["ring_attention", "attention_value_and_grad"])
def test_traces_for_the_cpu_hold_the_plain_products(name):
    """The same programs traced for the CPU take the plain version: no
    kernel node and the plain attention's matrix products, so a trace
    for the card that fell back to the plain version would fail."""
    got = ge.trace(name, device="cpu")
    assert got["kernel_nodes"] == {} and got["plain_products"] > 0
    assert got["ok"] is False
