"""Evidence of the port on the card, as one JSON record — the port's
counterpart of the reference's ``tools/tpu_evidence.py`` (the writer of
``TPU_EVIDENCE.json``)::

    python -m mpi_tpu_torch.tools.gpu_evidence [--records chiprun_out/chip_smoke.json]
        [--tier-log F] [--out F]

It writes ``chiprun_out/gpu_evidence.json`` unless ``--out`` names another
file.  Its sections, in the reference's order:

1. **card** (``probe_tunnel`` :56): a subprocess with a timeout imports
   torch and reports the device name and count and ``torch.version.cuda``;
   beside it the card's name and power limit as ``nvidia-smi
   --query-gpu=name,power.limit --format=csv,noheader`` prints them.
   ``ok`` is false, with the reason, when no CUDA device is visible.
   ``chip_smoke.py``, which already holds the card, reads it in process.
2. **gpu_tests** (``run_real_tpu_tier`` :77): ``MPI_TPU_TEST_TPU=1 python
   -m pytest -q -m gpu tests/test_torch_gpu_real.py -rA``, each test's
   outcome and pytest's summary line with singular keys (:94-103).  Run
   here, or parsed from a log of that same command (``--tier-log``), so
   that a call that has already run the tier does not run it twice.
3. **entry_on_card** (``run_entry_on_chip`` :110):
   ``mpi_tpu_torch.entry.entry()`` run on the card; the result's device,
   shapes and whether it is finite.
4. **export** (``run_cross_platform_export`` :134): ``aot.lower`` traces
   for the card on fake tensors (nothing is allocated or launched), with
   each kernel's graph nodes counted (``aot.kernel_nodes``): (a) the 1-D
   ``pallas_ring`` allreduce of 1024 float32 over 8 ranks (K1); (b) ring
   attention, forward, 8 ranks, d = 128, float32, at 64 and at 8192 rows a
   rank (K2), the latter with the kernels' shared-memory plan
   (``gpu/attention.py`` ``_kernel_plan``, ``kernel_smem_bytes``); (c) the
   value and gradient of a causal attention loss at 32 and 2048 rows a
   rank (K2 and K3, and no matrix product of the plain version); (d) the
   2 x 4 multi-parallel step with ``pallas_ring``, copied from
   ``chip_smoke.py``'s phase 6b record when one is given, else traced
   here.  A PyTorch built for the CPU only cannot trace for the card:
   each trace then records ``aot.lower``'s refusal.
5. **kernels** and **launches_by_path**, copied from ``chip_smoke.py``'s
   record when one is given.

A section that cannot run says ``skipped`` with its reason; it never
vanishes.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join("chiprun_out", "gpu_evidence.json")
PROBE_TIMEOUT_S = 120.0
TIER_TIMEOUT_S = 2400.0
TIER_ARGS = ("-m", "pytest", "-q", "-m", "gpu", "tests/test_torch_gpu_real.py", "-rA")
NVIDIA_SMI = ("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
P = 8

_PROBE = (
    "import json, torch\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "print(json.dumps({'torch': torch.__version__, 'cuda': torch.version.cuda,\n"
    "                  'count': n, 'device': torch.cuda.get_device_name(0) if n else None}))\n")


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _skipped(reason: str) -> dict:
    return {"ok": False, "skipped": reason}


# -- 1. the card ------------------------------------------------------------------


def _nvidia_smi() -> dict:
    try:
        r = subprocess.run(NVIDIA_SMI, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi_error": f"{type(e).__name__}: {e}"}
    if r.returncode != 0:
        return {"nvidia_smi_error": r.stderr.strip()[-300:] or f"exit {r.returncode}"}
    return {"nvidia_smi": r.stdout.strip()}


def probe_card(timeout: float = PROBE_TIMEOUT_S, in_process: bool = False) -> dict:
    """The device torch sees, probed in a subprocess that is killed after
    ``timeout`` seconds (or in this process, for a caller that already
    holds the card), and ``nvidia-smi``'s name and power limit."""
    if in_process:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        info = {"torch": torch.__version__, "cuda": torch.version.cuda, "count": n,
                "device": torch.cuda.get_device_name(0) if n else None,
                "probe": "in process"}
    else:
        try:
            r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                               text=True, timeout=timeout, cwd=ROOT)
        except subprocess.TimeoutExpired:
            return {"ok": False, "probe": "subprocess",
                    "reason": f"the probe did not finish in {timeout} s"}
        if r.returncode != 0:
            return {"ok": False, "probe": "subprocess", "reason": "the probe failed",
                    "stderr": r.stderr[-500:]}
        info = json.loads(r.stdout.strip().splitlines()[-1])
        info["probe"] = "subprocess"
    info.update(_nvidia_smi())
    info["ok"] = info["count"] > 0
    if not info["ok"]:
        info["reason"] = ("no CUDA device is visible (torch "
                          f"{info['torch']}, built for CUDA {info['cuda']})")
    return info


# -- 2. the card's test tier --------------------------------------------------------


_OUTCOME = re.compile(r"(PASSED|FAILED|ERROR|SKIPPED|XFAIL|XPASS)\s+(tests/\S+)")
_SUMMARY = re.compile(r"^=*\s*\d+ (passed|failed|skipped|deselected|errors?|warnings?"
                      r"|xfailed|xpassed)\b.* in [\d.]+s\b")
_COUNT = re.compile(r"(\d+) (passed|failed|skipped|deselected|errors?|warnings?"
                    r"|xfailed|xpassed)")


def parse_tier(text: str) -> dict:
    """Per-test outcomes (the ``-rA`` lines) and the tally of pytest's
    final summary line, with singular keys: pytest writes ``1 error`` but
    ``2 errors``, and the record's schema must not vary with the count."""
    tests, summary = {}, {}
    for line in text.splitlines():
        m = _OUTCOME.match(line)
        if m:
            tests[m.group(2)] = m.group(1)
        if _SUMMARY.match(line):  # only the final line, never a test's output
            summary = {{"errors": "error", "warnings": "warning"}.get(k, k): int(n)
                       for n, k in _COUNT.findall(line)}
    ok = bool(summary.get("passed")) and not summary.get("failed") \
        and not summary.get("error")
    return {"ok": ok, "summary": summary, "tests": tests,
            "tail": text.strip().splitlines()[-3:]}


def run_gpu_tier(timeout: float = TIER_TIMEOUT_S) -> dict:
    """The card's test tier, run here with per-test outcomes."""
    env = dict(os.environ, MPI_TPU_TEST_TPU="1")
    try:
        r = subprocess.run([sys.executable, *TIER_ARGS], capture_output=True,
                           text=True, timeout=timeout, cwd=ROOT, env=env)
    except subprocess.TimeoutExpired:
        return {"ok": False, "ran": False, "reason": f"the tier exceeded {timeout} s"}
    info = parse_tier(r.stdout)
    info.update(ran=True, returncode=r.returncode,
                ok=info["ok"] and r.returncode == 0)
    return info


def read_tier_log(path: str) -> dict:
    """``parse_tier`` of a log of the tier's command, run elsewhere."""
    with open(path) as f:
        info = parse_tier(f.read())
    info["log"] = path
    return info


# -- 3. entry() on the card ---------------------------------------------------------


def entry_on_card() -> dict:
    """``entry.entry()`` run on the card (its default device)."""
    import torch

    from .. import entry

    f, args = entry.entry()
    out = f(*args)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    device = out[0].device.type
    return {"ok": device == "cuda" and finite, "device": str(out[0].device),
            "shapes": [list(o.shape) for o in out], "finite": finite}


# -- 4. traces for the card ---------------------------------------------------------

# the plain attention's matrix products: a trace that took the kernels has none
_PRODUCTS = ("aten::mm", "aten::bmm", "aten::matmul", "aten::addmm", "aten::baddbmm")


def plain_products(graph) -> int:
    """Matrix-product nodes in a traced graph."""
    return sum(1 for n in graph.graph.nodes if n.op == "call_function"
               and getattr(n.target, "name", lambda: "")().split(".")[0] in _PRODUCTS)


def _ring_1d(device):
    from .. import aot
    from ..gpu import ring

    return aot.lower_spmd(
        lambda c, x: ring.ring_allreduce(x.reshape(P, -1)[c.rank], P, tile_rows=8),
        (1024,), nranks=P, device=device)


def _attention(rows: int, device):
    from .. import aot
    from ..gpu.attention import ring_attention

    def fwd(c, q, k, v):
        blk = lambda t: t.reshape(P, rows, 128)[c.rank]
        return ring_attention(blk(q), blk(k), blk(v), c)

    return aot.lower_spmd(fwd, *[(P * rows, 128)] * 3, nranks=P, device=device)


def _value_and_grad(rows: int, device):
    import torch

    from .. import aot
    from ..gpu.attention import ring_attention

    def train(c, q, k, v):
        blk = lambda t: t.reshape(P, rows, 128)[c.rank]
        loss = lambda q_, k_, v_: torch.sum(ring_attention(q_, k_, v_, c, causal=True) ** 2)
        grads, value = torch.func.grad_and_value(loss, argnums=(0, 1, 2))(
            blk(q), blk(k), blk(v))
        return c.allreduce(value), grads

    return aot.lower_spmd(train, *[(P * rows, 128)] * 3, nranks=P, device=device)


def _smem_plan() -> dict:
    import torch

    from ..gpu import attention

    attention._kernel_plan(128)  # raises for a head dim the kernels lack
    return {"head_dims": list(attention._HEAD_DIMS),
            "smem_bytes": attention.kernel_smem_bytes(128, torch.float32),
            "smem_limit": attention._SMEM_LIMIT}


# name -> (trace, the kernel nodes it must hold at least, no plain products)
TRACES: Dict[str, tuple] = {
    "pallas_ring_1d": (_ring_1d, {"ring_fold": 1}, False),
    "ring_attention": (lambda dev: _attention(64, dev), {"attn_fwd": 1}, True),
    "ring_attention_tiled": (lambda dev: _attention(8192, dev), {"attn_fwd": 1}, True),
    "attention_value_and_grad": (
        lambda dev: _value_and_grad(32, dev),
        {"attn_fwd": 1, "attn_bwd_dq": 1, "attn_bwd_dkv": 1}, True),
    "attention_value_and_grad_tiled": (
        lambda dev: _value_and_grad(2048, dev),
        {"attn_fwd": 1, "attn_bwd_dq": 1, "attn_bwd_dkv": 1}, True),
}


def trace(name: str, device="cuda") -> dict:
    """One trace of ``TRACES`` for ``device``: its kernel nodes and plain
    products, or ``aot.lower``'s refusal."""
    from .. import aot

    fn, want, no_products = TRACES[name]
    t0 = time.perf_counter()
    try:
        graph = fn(device)
    except RuntimeError as e:  # aot.lower's refusal on a build without CUDA
        return {"ok": False, "error": str(e)}
    nodes = aot.kernel_nodes(graph)
    products = plain_products(graph)
    info = {"ok": all(nodes.get(k, 0) >= n for k, n in want.items())
            and not (no_products and products),
            "kernel_nodes": nodes, "plain_products": products,
            "nodes": len(graph.graph.nodes), "seconds": time.perf_counter() - t0}
    if name.endswith("_tiled"):
        info["plan"] = _smem_plan()
    return info


def _multichip(records: Optional[dict]) -> dict:
    """(d): ``chip_smoke.py`` phase 6b's record, or a trace of the step."""
    if records is not None and "aot" in records:
        aot_rec = records["aot"]
        nodes = aot_rec["lower_kernel_nodes"]["pallas_ring"]
        return {"ok": nodes.get("ring_fold") == 1 and bool(nodes.get("attn_fwd")),
                "from": "chip_smoke.py phase 6b", "kernel_nodes": nodes, "record": aot_rec}
    from .. import aot, entry

    t0 = time.perf_counter()
    try:
        graph = entry.lower_multichip(P, "pallas_ring")
    except RuntimeError as e:
        return {"ok": False, "error": str(e)}
    nodes = aot.kernel_nodes(graph)
    return {"ok": nodes.get("ring_fold") == 1 and bool(nodes.get("attn_fwd")),
            "kernel_nodes": nodes, "nodes": len(graph.graph.nodes),
            "seconds": time.perf_counter() - t0}


def export(records: Optional[dict] = None) -> dict:
    """Section 4: every trace of ``TRACES`` for the card, then (d)."""
    out = {name: trace(name) for name in TRACES}
    out["multichip_2d_pallas_ring"] = _multichip(records)
    out["ok"] = all(v["ok"] for v in out.values())
    return out


# -- the record ---------------------------------------------------------------------


def collect(records: Optional[dict] = None, tier_log: Optional[str] = None,
            tier_skip: Optional[str] = None, in_process: bool = False,
            command: str = "python -m mpi_tpu_torch.tools.gpu_evidence") -> dict:
    """The evidence record.  ``records`` is ``chip_smoke.py``'s record
    (its ``aot``, ``kernels`` and ``launches_by_path``); ``tier_log`` a log
    of the card tier to parse in place of running it, ``tier_skip`` the
    reason the tier is not read at all; ``in_process`` probes the card in
    this process."""
    evidence = {"generated": _utcnow(), "command": command,
                "card": probe_card(in_process=in_process)}
    on_card = evidence["card"]["ok"]
    why_not = f"no CUDA device: {evidence['card'].get('reason')}"
    sections: Dict[str, Callable[[], dict]] = {
        "gpu_tests": (lambda: read_tier_log(tier_log)) if tier_log
        else (lambda: _skipped(tier_skip)) if tier_skip
        else run_gpu_tier if on_card else (lambda: _skipped(why_not)),
        "entry_on_card": entry_on_card if on_card else (lambda: _skipped(why_not)),
        "export": lambda: export(records),
    }
    for name, fn in sections.items():
        t0 = time.perf_counter()
        try:
            evidence[name] = fn()
        except Exception:  # noqa: BLE001 - the record says which section failed
            evidence[name] = {"ok": False, "error": traceback.format_exc()[-2000:]}
        evidence[name].setdefault("seconds", time.perf_counter() - t0)
    for key in ("kernels", "launches_by_path"):
        evidence[key] = (records[key] if records is not None and key in records
                         else _skipped("no chip_smoke.py record given (--records)"))
    return evidence


def write(evidence: dict, path: str = OUT) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(evidence, f, indent=1)
        f.write("\n")
    return path


def summary(evidence: dict) -> Dict[str, object]:
    """Each section's ``ok``, or ``"copied"`` for the copied records."""
    return {k: (v.get("ok") if isinstance(v, dict) and "ok" in v else "copied")
            for k, v in evidence.items() if k not in ("generated", "command")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--records", default=None,
                    help="chip_smoke.py's record (chiprun_out/chip_smoke.json)")
    ap.add_argument("--tier-log", default=None,
                    help="a log of the card tier's command, parsed in place of running it")
    ap.add_argument("--out", default=OUT, help=f"the record (default {OUT})")
    args = ap.parse_args(argv)
    records = None
    if args.records:
        with open(args.records) as f:
            records = json.load(f)
    evidence = collect(records, tier_log=args.tier_log,
                       command=" ".join(["python -m mpi_tpu_torch.tools.gpu_evidence",
                                         *(argv if argv is not None else sys.argv[1:])]))
    print(f"wrote {write(evidence, args.out)}")
    print(json.dumps(summary(evidence), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
