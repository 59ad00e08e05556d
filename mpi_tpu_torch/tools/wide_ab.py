"""Hold this tree's ring-attention forward above d = 256
(``csrc/attention_wide.cu``), or with ``--source attention`` its forward
at d = 128 and 256 (``csrc/attention.cu``), or with ``--source
attention_bwd`` its backward at d = 128 and 256 (``csrc/attention_bwd.cu``),
against a parent tree's, on one card, in one process.

    python -m mpi_tpu_torch.tools.wide_ab --parent PARENT [--source attention_wide|attention|attention_bwd] [--out chiprun_out/wide_ab.json]

Builds both trees' source (each beside its own headers, with
``_build.NVCC_FLAGS``, both at once) and prints each build's registers and
spills; then swaps each into ``_build._LIBS`` and

* ``attention_wide``: compares their bf16 out and lse bit for bit on
  ``chip_smoke.py`` phase 11's bf16 cases (``chip_smoke.parity_grid``) at
  d = 384, 512 and 1024, where the clusters make one pass and sum in the
  parent's order; times the forward of both at the wide serving shape
  (``chip_smoke.WIDE_SERVE``, causal, bf16 and float32) with CUDA events,
  in turns: parent, this tree, this tree, parent;
* ``attention``: compares both trees' bf16 out and lse bit for bit on
  phase 11's bf16 cases at d = 128 and 256 and holds both against the
  plain version (the largest share of ``chip_smoke.check_close``'s
  allowance each); times the bf16 forward of both, and SDPA's forward
  once, at the serving shape (``chip_smoke.SERVE``, causal) and at
  d = 256 with the same sequence and 16/4 heads, in the same turns;
* ``attention_bwd``: holds both trees' bf16 dq, dk and dv against the plain
  version on phase 11's bf16 cases at d = 128 and 256 (the largest share of
  ``chip_smoke.check_close``'s allowance each, and how many cases are
  bitwise the parent's); times ``bwd_dq`` and ``bwd_dkv`` of both at the
  serving shape (``chip_smoke.SERVE``, causal, bf16) in the same turns.

Writes ``--out`` and prints one line a result; exits 1 unless every
wide forward case is bitwise equal, or every narrow case within the
allowance.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

BITWISE_DIMS = (384, 512, 1024)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the parent tree")
    ap.add_argument("--source", default="attention_wide",
                    choices=("attention_wide", "attention", "attention_bwd"))
    ap.add_argument("--out", default="chiprun_out/wide_ab.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("wide_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mpi_tpu_torch import _build
    from mpi_tpu_torch.gpu import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    lib_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)), "wide_ab_build")
    os.makedirs(lib_dir, exist_ok=True)
    sources = {"parent": os.path.join(args.parent, "mpi_tpu_torch", "csrc", f"{args.source}.cu"),
               "cur": str(_build.SRC_DIR / f"{args.source}.cu")}
    procs = {}
    for name, src in sources.items():
        dst = os.path.join(lib_dir, f"{name}.so")
        procs[name] = dst, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", dst, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    res = {"card": chip_smoke.card_line(), "builds": {}}
    print(res["card"], flush=True)
    libs = {}
    for name, (dst, proc) in procs.items():
        log, _ = proc.communicate()
        rows = [(r.get("kernel"), r.get("registers"), r.get("spill_stores"), r.get("spill_loads"))
                for r in chip_smoke.ptxas_table({name: log})]
        res["builds"][name] = {"rc": proc.returncode, "kernels": rows}
        print(f"build {name}: rc {proc.returncode}, (kernel, registers, spill stores, loads) "
              f"{rows}", flush=True)
        if proc.returncode:
            print(log[-4000:], flush=True)
            continue
        lib = ctypes.CDLL(dst)
        for fn, argtypes in _build.SIGNATURES[args.source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    if len(libs) < 2:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        return 1

    if args.source in ("attention", "attention_bwd"):
        narrow = narrow_fwd if args.source == "attention" else narrow_bwd
        ok = narrow(torch, chip_smoke, _build, attention, libs, res)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        return 0 if ok else 1

    def fwd(name, q, k, v, groups, causal):
        _build._LIBS["attention_wide"] = libs[name]
        return attention.ring_attention_world(q, k, v, groups, causal=causal, with_lse=True)

    gen = torch.Generator(device="cuda").manual_seed(3)
    same, differ = 0, []
    for dh, sb, hq, hkv, causal, groups in chip_smoke.parity_grid(False):
        if dh not in BITWISE_DIMS:
            continue
        q, k, v = (torch.randn((chip_smoke.P, h, sb, dh), device="cuda", generator=gen)
                   .to(torch.bfloat16) for h in (hq, hkv, hkv))
        a, b = fwd("parent", q, k, v, groups, causal), fwd("cur", q, k, v, groups, causal)
        torch.cuda.synchronize()
        if torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]):
            same += 1
        else:
            differ.append(f"d={dh} sb={sb} {hq}/{hkv} causal={causal} "
                          f"groups={groups is not None}")
    res["bf16_bitwise_vs_parent"] = {"equal": same, "differ": differ}
    print(f"bf16 out and lse bitwise the parent's in {same} of {same + len(differ)} cases "
          f"(d = {', '.join(map(str, BITWISE_DIMS))}); differ: {differ[:4]}", flush=True)

    g = chip_smoke.WIDE_SERVE
    for dtype, reps in ((torch.bfloat16, 3), (torch.float32, 2)):
        q = torch.randn(chip_smoke.P, g["heads"], g["seq_per_rank"], g["d"], device="cuda",
                        generator=gen).to(dtype)
        k, v = (torch.randn(chip_smoke.P, g["kv_heads"], g["seq_per_rank"], g["d"], device="cuda",
                            generator=gen).to(dtype) for _ in range(2))
        tag = str(dtype).split(".")[-1]
        for name in ("parent", "cur", "cur", "parent"):
            fwd(name, q, k, v, None, True)  # warm-up
            ms = []
            for _ in range(reps):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                fwd(name, q, k, v, None, True)
                e1.record()
                torch.cuda.synchronize()
                ms.append(e0.elapsed_time(e1))
            res.setdefault("serving_ms", {}).setdefault(tag, {}).setdefault(name, []).extend(ms)
            print(f"time {tag} {name}: {[round(x, 3) for x in ms]} ms", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0 if not differ else 1


def narrow_fwd(torch, chip_smoke, _build, attention, libs, res) -> bool:
    """The ``attention`` comparison; True iff every case of both trees is
    within the allowance."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def fwd(name, *args, **kw):
        _build._LIBS["attention"] = libs[name]
        return attention.ring_attention_world(*args, **kw)

    gen = torch.Generator(device="cuda").manual_seed(3)
    used = {"parent": 0.0, "cur": 0.0}
    same, differ = 0, []
    for dh, sb, hq, hkv, causal, groups in chip_smoke.parity_grid(False):
        if dh > 256:
            continue
        q, k, v = (torch.randn((chip_smoke.P, h, sb, dh), device="cuda", generator=gen)
                   .to(torch.bfloat16) for h in (hq, hkv, hkv))
        want = attention.ring_attention_plain(q, k, v, groups, causal=causal, with_lse=True)
        got = {name: fwd(name, q, k, v, groups, causal=causal, with_lse=True) for name in libs}
        torch.cuda.synchronize()
        case = f"d={dh} sb={sb} {hq}/{hkv} causal={causal} groups={groups is not None}"
        for name, (out, lse) in got.items():
            used[name] = max(used[name],
                             chip_smoke.allowance_share(torch, f"{case} out", out, want[0],
                                                        torch.bfloat16)[1],
                             chip_smoke.allowance_share(torch, f"{case} lse", lse, want[1],
                                                        torch.float32)[1])
        if all(torch.equal(a, b) for a, b in zip(got["parent"], got["cur"])):
            same += 1
        else:
            differ.append(case)
    res["bf16_forward_vs_parent"] = {"largest_share": used, "equal": same, "differ": differ}
    print(f"bf16 forward at d = 128 and 256, {same + len(differ)} cases: largest share of the "
          f"allowance {used}, out and lse bitwise the parent's in {same}; differ: {differ[:4]}",
          flush=True)
    for label, g in (("serving", chip_smoke.SERVE),
                     ("d256", dict(chip_smoke.SERVE, d=256, heads=16, kv_heads=4))):
        q = torch.randn(chip_smoke.P, g["heads"], g["seq_per_rank"], g["d"], device="cuda",
                        generator=gen).to(torch.bfloat16)
        k, v = (torch.randn(chip_smoke.P, g["kv_heads"], g["seq_per_rank"], g["d"],
                            device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2))
        for name in ("parent", "cur", "cur", "parent"):
            ms = chip_smoke.time_ms(torch, lambda: fwd(name, q, k, v, causal=True, with_lse=True),
                                    reps=3, warmup=1)
            res.setdefault("serving_ms", {}).setdefault(label, {}).setdefault(name, []).append(ms)
            print(f"time fwd {label} {name}: {ms:.3f} ms", flush=True)
        ql, kl, vl = (chip_smoke.world_to_sequence(a) for a in (q, k, v))
        with torch.no_grad(), sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                                           SDPBackend.EFFICIENT_ATTENTION]):
            ms = chip_smoke.time_ms(torch, lambda: F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True, enable_gqa=True), reps=3, warmup=1)
        res.setdefault("library_fwd_ms", {})[label] = ms
        print(f"time SDPA forward {label}: {ms:.3f} ms", flush=True)
        del q, k, v, ql, kl, vl
        torch.cuda.empty_cache()
    return max(used.values()) <= 1.0


def narrow_bwd(torch, chip_smoke, _build, attention, libs, res) -> bool:
    """The ``attention_bwd`` comparison; True iff every case of both trees
    is within the allowance."""
    def bwd(name, *args, **kw):
        _build._LIBS["attention_bwd"] = libs[name]
        return attention.ring_attention_bwd_world(*args, **kw)

    gen = torch.Generator(device="cuda").manual_seed(3)
    used = {"parent": 0.0, "cur": 0.0}
    same = cases = 0
    for dh, sb, hq, hkv, causal, groups in chip_smoke.parity_grid(False):
        if dh > 256:
            continue
        q, k, v, do = (torch.randn((chip_smoke.P, h, sb, dh), device="cuda", generator=gen)
                       .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
        out, lse = attention.ring_attention_plain(q, k, v, groups, causal=causal, with_lse=True)
        want = attention.ring_attention_bwd_plain(q, k, v, out, lse, do, groups, causal=causal)
        got = {name: bwd(name, q, k, v, out, lse, do, groups, causal=causal) for name in libs}
        torch.cuda.synchronize()
        for name, grads in got.items():
            for a, b in zip(grads, want):
                used[name] = max(used[name], chip_smoke.allowance_share(
                    torch, "grad", a, b, torch.bfloat16)[1])
        same += all(torch.equal(a, b) for a, b in zip(got["parent"], got["cur"]))
        cases += 1
    res["bf16_backward_vs_plain"] = {"largest_share": used, "cases": cases,
                                     "bitwise_parent": same}
    print(f"bf16 backward at d = 128 and 256, {cases} cases: largest share of the allowance "
          f"{used}, bitwise the parent's in {same}", flush=True)
    g = chip_smoke.SERVE
    q, do = (torch.randn(chip_smoke.P, g["heads"], g["seq_per_rank"], g["d"], device="cuda",
                         generator=gen).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(chip_smoke.P, g["kv_heads"], g["seq_per_rank"], g["d"], device="cuda",
                        generator=gen).to(torch.bfloat16) for _ in range(2))
    out, lse = attention.ring_attention_world(q, k, v, causal=True, with_lse=True)
    ops = attention.bwd_operands(q, k, v, out, lse, do, causal=True)
    for name in ("parent", "cur", "cur", "parent"):
        _build._LIBS["attention_bwd"] = libs[name]
        for kind in ("bwd_dq", "bwd_dkv"):
            ms = chip_smoke.time_ms(torch, lambda: attention.launch_bwd(kind, ops), reps=3,
                                    warmup=1)
            res.setdefault("serving_ms", {}).setdefault(kind, {}).setdefault(name, []).append(ms)
            print(f"time {kind} {name}: {ms:.3f} ms", flush=True)
    return max(used.values()) <= 1.0


if __name__ == "__main__":
    sys.exit(main())
