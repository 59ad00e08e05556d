"""Hold this tree's ring-attention forward above d = 256
(``csrc/attention_wide.cu``), or with ``--source attention`` its forward
at d = 128 and 256 (``csrc/attention.cu``), or with ``--source
attention_bwd`` its backward at d = 128 and 256 (``csrc/attention_bwd.cu``),
against a parent tree's, on one card, in one process.

    python -m mpi_tpu_torch.tools.wide_ab --parent PARENT [--source attention_wide|attention|attention_bwd] [--dtype bfloat16|float32|both] [--out chiprun_out/wide_ab.json]

Builds both trees' source (each beside its own headers, with
``_build.NVCC_FLAGS``, both at once) and prints each build's registers and
spills (and any ptxas line naming a serialised ``wgmma``, ``C75xx``); then
swaps each into ``_build._LIBS`` and

* ``attention_wide``: compares their bf16 out and lse bit for bit on
  ``chip_smoke.py`` phase 11's bf16 cases (``chip_smoke.parity_grid``) at
  d = 384, 512 and 1024, where the clusters make one pass and sum in the
  parent's order; times the forward of both at the wide serving shape
  (``chip_smoke.WIDE_SERVE``, causal, bf16 and float32) with CUDA events,
  in turns: parent, this tree, this tree, parent;
* ``attention``: in each ``--dtype``, holds both trees' out and lse
  against the plain version on phase 11's cases of that dtype at d = 128
  and 256 (the largest share of ``chip_smoke.check_close``'s allowance
  each) and counts the cases whose out and lse are bitwise the parent's;
  in float32 also whether two launches of this tree's are bitwise equal;
  times the forward of both, and SDPA's forward once (bf16 with
  ``enable_gqa``, float32 with the K/V heads repeated, as phase 12 times
  them), at the serving shape (``chip_smoke.SERVE``, causal) and at
  d = 256 with the same sequence and 16/4 heads, in the same turns; in
  float32 holds both trees' out and lse from the timed operands against
  the plain version (one call) and prints each tree's share of the
  forward's bound and its ratio to SDPA's, at each shape;
* ``attention_bwd``: holds both trees' dq, dk and dv against the plain
  version on phase 11's cases at d = 128 and 256 of each ``--dtype`` (the
  largest share of ``chip_smoke.check_close``'s allowance each, how many
  cases are bitwise the parent's, and, in float32, whether two launches of
  this tree's are bitwise equal); times ``bwd_dq`` and ``bwd_dkv`` of both
  at the serving shape (``chip_smoke.SERVE``, causal) in the same turns,
  and in float32 also at d = 256 with the same sequence and 16/4 heads,
  with SDPA's float32 backward alone once at each (K/V heads repeated, as
  phase 12 times it); at each timed shape holds both trees' dq, dk and dv
  from the timed operands against the plain backward (one call, timed:
  the largest share of the normwise allowance phase 12 holds the serving
  shape to) and this tree's two launches bitwise; prints each tree's
  kernels' share of their bounds and, in float32, the pair's ratio to
  SDPA's backward, at each shape.

Writes ``--out`` and prints one line a result; exits 1 unless every
wide forward case is bitwise equal, or every narrow case within the
allowance (at the timed shapes too).  It needs a CUDA card.
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
    ap.add_argument("--dtype", default="both", choices=("bfloat16", "float32", "both"),
                    help="the input dtypes (--source attention or attention_bwd)")
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
        c75 = [line.strip() for line in log.splitlines() if "C75" in line]
        res["builds"][name] = {"rc": proc.returncode, "kernels": rows, "c75": c75}
        print(f"build {name}: rc {proc.returncode}, (kernel, registers, spill stores, loads) "
              f"{rows}; C75xx lines: {c75}", flush=True)
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
        dtypes = {"bfloat16": (torch.bfloat16,), "float32": (torch.float32,),
                  "both": (torch.float32, torch.bfloat16)}[args.dtype]
        narrow = narrow_fwd if args.source == "attention" else narrow_bwd
        ok = all([narrow(torch, chip_smoke, _build, attention, libs, res, dt) for dt in dtypes])
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


def narrow_fwd(torch, chip_smoke, _build, attention, libs, res, dtype) -> bool:
    """The ``attention`` comparison in one input dtype; True iff every case
    of both trees is within the allowance (and, in float32, two launches of
    this tree's are bitwise equal and both trees hold at the timed shapes)."""
    import statistics

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def fwd(name, *args, **kw):
        _build._LIBS["attention"] = libs[name]
        return attention.ring_attention_world(*args, **kw)

    f32 = dtype == torch.float32
    tag = "float32" if f32 else "bf16"
    gen = torch.Generator(device="cuda").manual_seed(3)
    used = {"parent": 0.0, "cur": 0.0}
    same, differ = 0, []
    repeatable = True
    for dh, sb, hq, hkv, causal, groups in chip_smoke.parity_grid(f32):
        if dh > 256:
            continue
        q, k, v = (torch.randn((chip_smoke.P, h, sb, dh), device="cuda", generator=gen)
                   .to(dtype) for h in (hq, hkv, hkv))
        want = attention.ring_attention_plain(q, k, v, groups, causal=causal, with_lse=True)
        got = {name: fwd(name, q, k, v, groups, causal=causal, with_lse=True) for name in libs}
        if f32:
            again = fwd("cur", q, k, v, groups, causal=causal, with_lse=True)
            repeatable &= all(torch.equal(a, b) for a, b in zip(got["cur"], again))
        torch.cuda.synchronize()
        case = f"d={dh} sb={sb} {hq}/{hkv} causal={causal} groups={groups is not None}"
        for name, (out, lse) in got.items():
            used[name] = max(used[name],
                             chip_smoke.allowance_share(torch, f"{case} out", out, want[0],
                                                        dtype)[1],
                             chip_smoke.allowance_share(torch, f"{case} lse", lse, want[1],
                                                        torch.float32)[1])
        if all(torch.equal(a, b) for a, b in zip(got["parent"], got["cur"])):
            same += 1
        else:
            differ.append(case)
    res[f"{tag}_forward_vs_parent"] = {"largest_share": used, "equal": same, "differ": differ}
    if f32:
        res[f"{tag}_forward_vs_parent"]["two_launches_bitwise_equal"] = repeatable
    print(f"{tag} forward at d = 128 and 256, {same + len(differ)} cases: largest share of the "
          f"allowance {used}, out and lse bitwise the parent's in {same}"
          + (f", two launches bitwise equal: {repeatable}" if f32 else "")
          + f"; differ: {differ[:4]}", flush=True)
    timed_ok = True
    for label, g in (("serving", chip_smoke.SERVE),
                     ("d256", dict(chip_smoke.SERVE, d=256, heads=16, kv_heads=4))):
        q = torch.randn(chip_smoke.P, g["heads"], g["seq_per_rank"], g["d"], device="cuda",
                        generator=gen).to(dtype)
        k, v = (torch.randn(chip_smoke.P, g["kv_heads"], g["seq_per_rank"], g["d"],
                            device="cuda", generator=gen).to(dtype) for _ in range(2))
        key = label if not f32 else f"{tag}_{label}"
        for name in ("parent", "cur", "cur", "parent"):
            ms = chip_smoke.time_ms(torch, lambda: fwd(name, q, k, v, causal=True, with_lse=True),
                                    reps=3, warmup=1)
            res.setdefault("serving_ms", {}).setdefault(key, {}).setdefault(name, []).append(ms)
            print(f"time fwd {key} {name}: {ms:.3f} ms", flush=True)
        ql, kl, vl = (chip_smoke.world_to_sequence(a) for a in (q, k, v))
        if f32:  # as phase 12: the float32 library call takes expanded heads
            rep = g["heads"] // g["kv_heads"]
            kl, vl = kl.repeat_interleave(rep, 1), vl.repeat_interleave(rep, 1)
        with torch.no_grad(), sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                                           SDPBackend.EFFICIENT_ATTENTION]):
            ms = chip_smoke.time_ms(torch, lambda: F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True, enable_gqa=not f32), reps=3, warmup=1)
        res.setdefault("library_fwd_ms", {})[key] = ms
        print(f"time SDPA forward {key}: {ms:.3f} ms", flush=True)
        del ql, kl, vl
        if f32:
            got = {name: fwd(name, q, k, v, causal=True, with_lse=True) for name in libs}
            want, plain_ms = chip_smoke.time_once(torch, lambda: attention.ring_attention_plain(
                q, k, v, causal=True, with_lse=True))
            held = {"plain_ms": plain_ms}
            for name, (out, lse) in got.items():
                held[name] = max(
                    chip_smoke.allowance_share(torch, "out", out, want[0], dtype)[1],
                    chip_smoke.allowance_share(torch, "lse", lse, want[1], torch.float32)[1])
                timed_ok &= held[name] <= 1.0
            res.setdefault("timed_vs_plain", {})[key] = held
            shape = (chip_smoke.P, g["heads"], g["kv_heads"], g["seq_per_rank"], g["d"])
            bound, by, _ = chip_smoke.attention_bound(
                "fwd", 4, chip_smoke.F32_SPLIT_TF32_FLOPS, shape, {"q": 1, "kv": 2},
                {"q": 1, "rows": 1})
            out = res.setdefault("bounds", {}).setdefault(key, {"bound_ms": bound,
                                                                 "bound_by": by})
            for name, runs in res["serving_ms"][key].items():
                med = statistics.median(runs)
                out[name] = {"ms": med, "pct_of_bound": 100.0 * bound / med,
                             "over_library": med / ms}
                print(f"{key} fwd {name}: {med:.3f} ms, {out[name]['pct_of_bound']:.2f}% of its "
                      f"{bound:.3f} ms bound ({by}), {med / ms:.3f}x SDPA's {ms:.3f} ms; against "
                      f"the plain version ({plain_ms:.3f} ms, one call): largest share of the "
                      f"allowance {held[name]:.4g}", flush=True)
            del got, want
        del q, k, v
        torch.cuda.empty_cache()
    return max(used.values()) <= 1.0 and repeatable and timed_ok


def narrow_bwd(torch, chip_smoke, _build, attention, libs, res, dtype) -> bool:
    """The ``attention_bwd`` comparison in one input dtype; True iff every
    case of both trees is within the allowance (and, in float32, two
    launches of this tree's are bitwise equal)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def bwd(name, *args, **kw):
        _build._LIBS["attention_bwd"] = libs[name]
        return attention.ring_attention_bwd_world(*args, **kw)

    f32 = dtype == torch.float32
    tag = "float32" if f32 else "bf16"
    gen = torch.Generator(device="cuda").manual_seed(3)
    used = {"parent": 0.0, "cur": 0.0}
    same = cases = 0
    repeatable = True
    for dh, sb, hq, hkv, causal, groups in chip_smoke.parity_grid(f32):
        if dh > 256:
            continue
        q, k, v, do = (torch.randn((chip_smoke.P, h, sb, dh), device="cuda", generator=gen)
                       .to(dtype) for h in (hq, hkv, hkv, hq))
        out, lse = attention.ring_attention_plain(q, k, v, groups, causal=causal, with_lse=True)
        want = attention.ring_attention_bwd_plain(q, k, v, out, lse, do, groups, causal=causal)
        got = {name: bwd(name, q, k, v, out, lse, do, groups, causal=causal) for name in libs}
        if f32:
            again = bwd("cur", q, k, v, out, lse, do, groups, causal=causal)
            repeatable &= all(torch.equal(a, b) for a, b in zip(got["cur"], again))
        torch.cuda.synchronize()
        for name, grads in got.items():
            for a, b in zip(grads, want):
                used[name] = max(used[name], chip_smoke.allowance_share(
                    torch, "grad", a, b, dtype)[1])
        same += all(torch.equal(a, b) for a, b in zip(got["parent"], got["cur"]))
        cases += 1
    res[f"{tag}_backward_vs_plain"] = {"largest_share": used, "cases": cases,
                                       "bitwise_parent": same}
    if f32:
        res[f"{tag}_backward_vs_plain"]["two_launches_bitwise_equal"] = repeatable
    print(f"{tag} backward at d = 128 and 256, {cases} cases: largest share of the allowance "
          f"{used}, bitwise the parent's in {same}"
          + (f", two launches bitwise equal: {repeatable}" if f32 else ""), flush=True)
    timed_ok = True
    shapes = [("serving", chip_smoke.SERVE)]
    if f32:
        shapes.append(("d256", dict(chip_smoke.SERVE, d=256, heads=16, kv_heads=4)))
    for label, g in shapes:
        q, do = (torch.randn(chip_smoke.P, g["heads"], g["seq_per_rank"], g["d"], device="cuda",
                             generator=gen).to(dtype) for _ in range(2))
        k, v = (torch.randn(chip_smoke.P, g["kv_heads"], g["seq_per_rank"], g["d"],
                            device="cuda", generator=gen).to(dtype) for _ in range(2))
        out, lse = attention.ring_attention_world(q, k, v, causal=True, with_lse=True)
        ops = attention.bwd_operands(q, k, v, out, lse, do, causal=True)
        key = f"{tag}_{label}"
        for name in ("parent", "cur", "cur", "parent"):
            _build._LIBS["attention_bwd"] = libs[name]
            for kind in ("bwd_dq", "bwd_dkv"):
                ms = chip_smoke.time_ms(torch, lambda: attention.launch_bwd(kind, ops), reps=3,
                                        warmup=1)
                res.setdefault("serving_ms", {}).setdefault(key, {}).setdefault(
                    kind, {}).setdefault(name, []).append(ms)
                print(f"time {tag} {label} {kind} {name}: {ms:.3f} ms", flush=True)
        got = {}
        for name in ("parent", "cur", "again"):
            _build._LIBS["attention_bwd"] = libs["parent" if name == "parent" else "cur"]
            got[name] = attention.launch_bwd("bwd_dq", ops) + attention.launch_bwd("bwd_dkv", ops)
        del ops
        want, plain_ms = chip_smoke.time_once(torch, lambda: attention.ring_attention_bwd_plain(
            q, k, v, out, lse, do, causal=True))
        twice = all(torch.equal(a, b) for a, b in zip(got["cur"], got["again"]))
        held = {"plain_ms": plain_ms, "two_launches_bitwise_equal": twice}
        for name in ("parent", "cur"):
            normwise, elementwise = hold_timed(torch, chip_smoke, got[name], want, dtype)
            held[name] = {"normwise_share": normwise, "elementwise_share": elementwise}
            timed_ok &= normwise <= 1.0
        timed_ok &= twice
        res.setdefault("timed_vs_plain", {})[key] = held
        print(f"{key} against the plain backward ({plain_ms:.3f} ms, one call): largest share of "
              f"the normwise allowance parent {held['parent']['normwise_share']:.4g}, this tree "
              f"{held['cur']['normwise_share']:.4g} (elementwise, recorded only: parent "
              f"{held['parent']['elementwise_share']:.4g}, this tree "
              f"{held['cur']['elementwise_share']:.4g}); this tree's two launches bitwise equal: "
              f"{twice}", flush=True)
        del got, want
        if f32:
            rep = g["heads"] // g["kv_heads"]
            ql, dol = (chip_smoke.world_to_sequence(a).requires_grad_(a is q) for a in (q, do))
            kl, vl = (chip_smoke.world_to_sequence(a).repeat_interleave(rep, 1)
                      .requires_grad_(True) for a in (k, v))
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
                o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
            ms = chip_smoke.time_ms(torch, lambda: torch.autograd.grad(
                o, (ql, kl, vl), dol, retain_graph=True), reps=3, warmup=1)
            res.setdefault("library_bwd_ms", {})[key] = ms
            print(f"time SDPA {tag} backward alone {label}: {ms:.3f} ms", flush=True)
            del ql, kl, vl, dol, o
        shares(chip_smoke, res, key, (chip_smoke.P, g["heads"], g["kv_heads"], g["seq_per_rank"],
                                      g["d"]), f32)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return max(used.values()) <= 1.0 and repeatable and timed_ok


def hold_timed(torch, chip_smoke, got, want, dtype):
    """One tree's (dq, dk, dv) at a timed shape against the plain
    backward's on the same operands: (the largest share of
    ``chip_smoke.check_close``'s allowance there, normwise as phase 12
    holds the serving shape; the largest share of the elementwise
    allowance, recorded only)."""
    return tuple(max(chip_smoke.allowance_share(torch, "grad", a, b, dtype, normwise=nw)[1]
                     for a, b in zip(got, want)) for nw in (True, False))


# what each backward kernel reads and writes once (phase 12's bounds)
BWD_IO = {"bwd_dq": ({"q": 2, "kv": 2, "rows": 2}, {"q": 1}),
          "bwd_dkv": ({"q": 2, "kv": 2, "rows": 2}, {"kv": 2})}


def shares(chip_smoke, res, key, shape, f32):
    """Each tree's backward kernels at one shape beside their bounds (the
    median of a tree's runs: ms, % of bound, TFLOP/s) and, in float32, the
    pair's ratio to SDPA's float32 backward alone; into ``res`` and
    printed."""
    import statistics

    peak = chip_smoke.F32_SPLIT_TF32_FLOPS if f32 else chip_smoke.BF16_FLOPS
    runs = res["serving_ms"][key]
    out = res.setdefault("bounds", {}).setdefault(key, {})
    for kind, (reads, writes) in BWD_IO.items():
        bound, by, _ = chip_smoke.attention_bound(kind, 4 if f32 else 2, peak, shape, reads, writes)
        out[kind] = {"bound_ms": bound, "bound_by": by}
        for name, ms in runs[kind].items():
            med = statistics.median(ms)
            flops = chip_smoke.FLOPS_PER_ENTRY[kind] * shape[4] * chip_smoke.causal_entries(shape)
            out[kind][name] = {"ms": med, "pct_of_bound": 100.0 * bound / med,
                               "tflops": flops / (med * 1e-3) / 1e12}
            print(f"{key} {kind} {name}: {med:.3f} ms, {out[kind][name]['pct_of_bound']:.2f}% of "
                  f"its {bound:.3f} ms bound ({by}), {out[kind][name]['tflops']:.1f} TFLOP/s",
                  flush=True)
    lib = res.get("library_bwd_ms", {}).get(key)
    if lib:
        for name in runs["bwd_dq"]:
            pair = out["bwd_dq"][name]["ms"] + out["bwd_dkv"][name]["ms"]
            out[f"pair_over_library_{name}"] = pair / lib
            print(f"{key} pair {name}: {pair:.3f} ms, {pair / lib:.3f}x SDPA's {lib:.3f}",
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
