#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero without the final
ok line:

1. the card's name and power limit (nvidia-smi) and the kernel build
   (``nvcc`` of every ``mpi_tpu_torch/csrc`` source, in parallel, timed),
   with the registers and spills ``ptxas`` reports for every kernel
   instance;
2. Jacobi through ``mpi_tpu_torch.run(jacobi_program, nranks=8)`` on the
   card, against the same program on the CPU;
3. the main path of the collectives: a data-parallel step through ``run(..., nranks=8)`` with a
   256 MiB float32 gradient per rank that differs by rank — the north-star
   ``allreduce(algorithm="pallas_ring")``, then the ZeRO pair
   ``reduce_scatter`` / ``allgather`` on the same kernel.  Launch counters
   are zeroed just before and read just after; every mode must have
   launched.  Each result must equal the plain version on the card
   (``torch.equal``, bitwise) and the allreduce must agree with a float64
   sum (rtol 1e-5);
4. kernel vs plain version on the card, bitwise (``torch.equal``, NaN
   positions included), for every mode x {float32, bfloat16} x
   {SUM, MAX, MIN} x {whole world, 2 groups of 4} at ragged and aligned
   small sizes;
5. timing with CUDA events at the north-star sizes: the kernel and one
   PyTorch library call computing the same function, in turns (kernel,
   library, library, kernel, twice), each turn timed two ways: launched one
   at a time with a synchronisation after each (``time_ms``, median of 10
   runs after 2 warm-up runs; it holds the host's time to prepare the
   launch: the ``ms`` and ``library_ms`` of the ``kernels`` line) and 20
   back-to-back launches (``time_b2b``, median of 5: the card's time alone,
   ``ms_b2b`` and ``library_ms_b2b``), the median of each side's four
   turns; the plain version (``time_ms``); beside the least time the card
   could take (bytes moved over the 3.35 TB/s datasheet rate), and the
   measured device-to-device copy rate;
6. ring attention, serving leg: a per-rank program that draws its Q/K/V
   with ``mpi_tpu_torch.rank_normal`` and calls
   ``mpi_tpu_torch.gpu.attention.ring_attention``, through ``run(...,
   nranks=8)``, at Llama-3-8B's attention geometry (32 query heads, 8 K/V
   heads, head dim 128; ``meta-llama/Meta-Llama-3-8B`` ``config.json``)
   over a causal sequence of 32 768 (4096 rows per rank), bfloat16 and then
   float32.  The forward kernel must have launched; the output must agree
   with the plain version on the card (see ``check_close``);
7. ring attention, training leg: one ``sharded_train_step`` of
   ``mpi_tpu_torch.examples.long_context_training`` through ``run(...,
   nranks=8)`` at 4096 rows per rank, d = 128, float32, causal.  Every
   attention kernel must have launched; loss and gradients must agree with
   the dense one-device step on the card (the tolerances of
   ``tests/test_long_context.py:180-185``);
8. attention kernels vs plain versions on the card: {float32, bfloat16} x
   {full, causal} x {MHA 4/4, GQA 4/2, MQA 4/1} x {world of 8, 2 groups of
   4} x Sb in {16, 48, 112, 128} x d in {128, 256}, forward (out and lse)
   and backward (dq, dk, dv), with the tolerances of ``check_close``
   (Sb = 16, 48 and 112 end in a partial 64-row tile);
9. attention at the serving shape, in bfloat16 (the ``kernels`` line) and
   float32 (the record): the forward (out and lse) and the backward
   kernels against the plain version (see ``check_close``), the backward
   against itself (two launches must be bitwise equal: no atomics, a
   fixed order of sums); then timing with CUDA events: forward, backward
   (both kernels and each alone), the plain versions (3 runs), and as a
   yardstick only ``scaled_dot_product_attention`` on the whole sequence
   (forward, backward alone from the forward's saved outputs, and both),
   beside the least time the card could take (operations over the
   datasheet peak: 989 TFLOP/s for bfloat16 inputs; for float32, 495/3
   TFLOP/s, the rate of a float32-accurate product split into three TF32
   tensor-core products, as every attention kernel multiplies; bytes over
   3.35 TB/s), the achieved TFLOP/s and each kernel's design floor
   (``FLOOR_FLOPS_PER_ENTRY``);
10. one ``{"kernels": [...]}`` JSON line, then the ok line.

Every phase prints its wall time.  The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM datasheet
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
F32_SPLIT_TF32_FLOPS = 495e12 / 3   # float32 products as three TF32 products
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor cores
BF16_ROUNDING = 2.0 ** -7       # one bfloat16 ulp of x is at most 2^-7 |x|
P = 8
NORTH_STAR_ELEMS = (256 << 20) // 4     # 256 MiB of float32 per rank
REPLACES = "mpi_tpu/tpu/pallas_ring.py:434"
SOURCE = "mpi_tpu_torch/csrc/ring.cu"
ATTN_SOURCE = {"fwd": "mpi_tpu_torch/csrc/attention.cu",
               "bwd_dq": "mpi_tpu_torch/csrc/attention_bwd.cu",
               "bwd_dkv": "mpi_tpu_torch/csrc/attention_bwd.cu"}
ATTN_REPLACES = {"fwd": "mpi_tpu/tpu/pallas_attention.py:1059",
                 "bwd_dq": "mpi_tpu/tpu/pallas_attention.py:1130",
                 "bwd_dkv": "mpi_tpu/tpu/pallas_attention.py:1130"}
# the serving leg: Llama-3-8B attention (meta-llama/Meta-Llama-3-8B config.json:
# num_attention_heads 32, num_key_value_heads 8, head dim 4096/32 = 128),
# 8 ranks x 4096 rows = a causal sequence of 32 768
SERVE = dict(seq_per_rank=4096, d=128, heads=32, kv_heads=8)
TRAIN_SEQ_PER_RANK = 4096       # the training leg: 8 x 4096 rows, d = 128
# flops per unmasked score entry and head dim (bench.py:198-233): forward
# QK^T and PV; backward QK^T, dO V^T, dS K, dS^T Q, P^T dO (dq alone needs
# the first three, dk/dv the first two and the last two)
FLOPS_PER_ENTRY = {"fwd": 4, "bwd": 10, "bwd_dq": 6, "bwd_dkv": 8}
# what the kernels' design multiplies per entry and head dim
# (csrc/attention.cu, csrc/attention_bwd.cu): each backward kernel
# recomputes QK^T and dO V^T; bf16 inputs: a product with P or dS is two
# bf16 products (hi and lo), so the forward 2 + 2 x 2 = 6, dq 2 + 2 x 2 = 8,
# dk/dv 4 + 2 x 4 = 12; float32 inputs: every product is three TF32
# products, the forward 3 x 4, dq 3 x 6, dk/dv 3 x 8 (at the TF32 peak)
FLOOR_FLOPS_PER_ENTRY = {
    "bf16": {"fwd": 6, "bwd": 20, "bwd_dq": 8, "bwd_dkv": 12},
    "f32": {"fwd": 12, "bwd": 42, "bwd_dq": 18, "bwd_dkv": 24}}
TF32_FLOPS = 495e12             # H100 SXM dense TF32 tensor cores


def log(msg):
    print(msg, flush=True)


def ptxas_table(reports):
    """Registers and spills of every kernel instance, from ``nvcc -Xptxas
    -v`` output by source."""
    rows = []
    for source, text in reports.items():
        cur = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = {"source": source, "function": m.group(1)}
                k = re.search(r"\d(attn_[a-z_]+_kernel)I(13__nv_bfloat16|f)Li(\d+)E", m.group(1))
                if k:
                    cur["kernel"] = (f"{k.group(1)}<{'float32' if k.group(2) == 'f' else 'bf16'}, "
                                     f"{k.group(3)}>")
                rows.append(cur)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
    return rows


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def nan_equal(torch, a, b):
    return torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def spread_data(torch, gen, shape, device):
    """Random signs and magnitudes from 1e-4 to 1e8: the fold order shows."""
    mag = torch.pow(10.0, torch.empty(shape, device=device).uniform_(-4, 8, generator=gen))
    return torch.randn(shape, device=device, generator=gen) * mag


_LAP = [time.perf_counter()]


def lap(name):
    """Print the wall time since the previous phase ended."""
    now = time.perf_counter()
    log(f"[phase {name}: {now - _LAP[0]:.2f} s wall]")
    _LAP[0] = now


def time_ms(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_b2b(torch, fn, launches=20, reps=5):
    """Median ms per launch over ``reps`` timings of ``launches``
    back-to-back launches between two CUDA events: the host enqueues a
    launch while the card runs the one before, so this is the card's time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def world_to_sequence(t):
    """``[P, H, Sb, d]`` rank blocks -> ``[1, H, P*Sb, d]`` whole sequence."""
    P, H, sb, d = t.shape
    return t.transpose(0, 1).reshape(1, H, P * sb, d).contiguous()


def causal_entries(shape):
    """Unmasked score entries of causal attention over the whole sequence."""
    P, hq, hkv, sb, d = shape
    S = P * sb
    return hq * S * (S + 1) / 2


def attention_bound(kind, dtype_bytes, peak, shape, reads, writes):
    """(bound_ms, bound_by) at the serving shape for one function:
    operations over the unmasked causal entries, bytes = each input read
    once and each output written once."""
    P, hq, hkv, sb, d = shape
    entries = causal_entries(shape)
    op_ms = FLOPS_PER_ENTRY[kind] * d * entries / peak * 1e3
    q_elems, kv_elems, row_elems = P * hq * sb * d, P * hkv * sb * d, P * hq * sb
    sizes = {"q": q_elems * dtype_bytes, "kv": kv_elems * dtype_bytes,
             "rows": row_elems * 4}
    nbytes = sum(sizes[n] * c for n, c in reads.items()) + \
        sum(sizes[n] * c for n, c in writes.items())
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes"), nbytes


# the largest share of its allowance that any comparison used, by kind
ALLOWANCE_USED = {}


def check_close(torch, name, got, want, dtype, normwise=False):
    """Hold a kernel's result against its plain version's; both are float32
    sums in different orders, rounded once to their output type.

    float32 allowance per element: out and lse 1e-5; gradients
    1e-5 + 1e-4 |plain|, or with ``normwise`` (the serving shape, where
    one dK/dV element sums up to 131 072 products in another order than
    the plain version) 1e-4 * max |plain|.  bfloat16: the float32
    allowance plus 2^-7 |plain|, since each side rounds a float32 value to
    bfloat16 once and two such roundings of values that agree within the
    float32 allowance differ by at most that allowance and one bfloat16
    ulp.  Returns the max abs error."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise RuntimeError(f"{name}: non-finite values")
    if name.endswith(("out", "lse")):
        kind, allow = name[-3:], torch.full_like(w, 1e-5)
    elif normwise:
        kind, allow = "grad_normwise", torch.full_like(w, 1e-4 * float(w.abs().max()))
    else:
        kind, allow = "grad", 1e-5 + 1e-4 * w.abs()
    if dtype == torch.bfloat16:
        allow = allow + BF16_ROUNDING * w.abs()
    diff = (g - w).abs()
    err, used = float(diff.max()), float((diff / allow).max())
    key = f"{str(dtype).split('.')[-1]} {kind}"
    ALLOWANCE_USED[key] = max(ALLOWANCE_USED.get(key, 0.0), used)
    if used > 1.0:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version "
                           f"(max abs {err}, {used:.3g} of the allowance)")
    return err


def serving_program(comm, dtype):
    """One rank of the serving leg: Q/K/V from the rank's own generator,
    then causal ring attention at Llama-3-8B's head geometry."""
    import mpi_tpu_torch
    from mpi_tpu_torch.gpu.attention import ring_attention

    sb, d = SERVE["seq_per_rank"], SERVE["d"]
    q = mpi_tpu_torch.rank_normal((SERVE["heads"], sb, d), 7).to(dtype)
    k, v = (mpi_tpu_torch.rank_normal((SERVE["kv_heads"], sb, d), seed).to(dtype)
            for seed in (8, 9))
    return ring_attention(q, k, v, comm, causal=True), q, k, v


def attention_phases(torch, dev, gen, record):
    """Phases 6-9; returns the three attention entries of the kernels line."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import mpi_tpu_torch
    from mpi_tpu_torch.examples import long_context_training as lct
    from mpi_tpu_torch.gpu import attention

    main_launches = {k: 0 for k in attention.LAUNCHES}
    errs = {}

    # 6. serving leg at full width ---------------------------------------------
    serve = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        attention.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, q, k, v = mpi_tpu_torch.run(serving_program, dtype, nranks=P)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(attention.LAUNCHES)
        if launches["fwd"] == 0:
            raise RuntimeError(f"serving leg ({tag}) never launched the forward kernel")
        for key, c in launches.items():
            main_launches[key] += c
        if tuple(out.shape) != (P, SERVE["heads"], SERVE["seq_per_rank"], SERVE["d"]) \
                or out.dtype != dtype:
            raise RuntimeError(f"serving leg output {tuple(out.shape)} {out.dtype}")
        want = attention.ring_attention_plain(q, k, v, causal=True)
        err = check_close(torch, f"serving {tag} out", out, want, dtype)
        errs[("fwd", dtype)] = err
        serve[dtype] = (q, k, v)
        record[f"serving_{tag}"] = {"run_s": run_s, "launches": launches,
                                    "max_abs_err_vs_plain": err,
                                    "shape": list(out.shape)}
        log(f"serving leg {tag}: run {run_s:.3f} s, launches {launches}, "
            f"max abs err vs plain {err:.3g}")
        del out, want
    lap("attention serving leg")

    # 7. training leg at the example's width -------------------------------------
    d, S = 128, P * TRAIN_SEQ_PER_RANK
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(S, d).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(S, d).astype(np.float32)).to(dev)
    block = lct.block_from_numpy(lct.init_params(d, 2 * d), dev)
    params = {n: p.detach() for n, p in block.named_parameters()}
    attention.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_s, grads_s = mpi_tpu_torch.run(lct.sharded_program, block, params, x, y,
                                        nranks=P)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(attention.LAUNCHES)
    missing = [k for k, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"training leg never launched {missing}")
    for key, c in launches.items():
        main_launches[key] += c
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # a second step: the first pays first-call costs
    mpi_tpu_torch.run(lct.sharded_program, block, params, x, y, nranks=P)
    torch.cuda.synchronize()
    step2_s = time.perf_counter() - t0
    loss_d, grads_d = lct.dense_train_step(block)(params, x, y)
    torch.cuda.synchronize()
    if not (torch.isfinite(loss_s).all() and
            torch.allclose(loss_s[0], loss_d, rtol=1e-5, atol=1e-6)):
        raise RuntimeError(f"training loss {float(loss_s[0])} != dense {float(loss_d)}")
    grad_err = {}
    for name, g in grads_d.items():
        if not torch.allclose(grads_s[name][0], g, rtol=5e-4, atol=5e-5):
            raise RuntimeError(f"training gradient {name} disagrees with the dense step")
        grad_err[name] = float((grads_s[name][0] - g).abs().max())
    record["training"] = {"step_s": step_s, "second_step_s": step2_s,
                          "launches": launches,
                          "loss": float(loss_s[0]), "dense_loss": float(loss_d),
                          "grad_max_abs_err_vs_dense": grad_err,
                          "seq": S, "d": d, "nranks": P}
    log(f"training leg: step {step_s:.3f} s (second {step2_s:.3f} s), "
        f"launches {launches}, loss "
        f"{float(loss_s[0]):.6f} vs dense {float(loss_d):.6f}")
    del x, y, block, params, loss_s, grads_s, loss_d, grads_d
    torch.cuda.empty_cache()
    lap("attention training leg")

    # 8. kernel vs plain grid ---------------------------------------------------
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (128, 256):
            for sb in (16, 48, 112, 128):
                for hq, hkv in ((4, 4), (4, 2), (4, 1)):
                    for causal in (False, True):
                        for groups in (None, [[0, 1, 2, 3], [4, 5, 6, 7]]):
                            q, k, v, do = (torch.randn(
                                (P, h, sb, dh), device=dev, generator=gen).to(dtype)
                                for h in (hq, hkv, hkv, hq))
                            out, lse = attention.ring_attention_world(
                                q, k, v, groups, causal=causal, with_lse=True)
                            pout, plse = attention.ring_attention_plain(
                                q, k, v, groups, causal=causal, with_lse=True)
                            grads = attention.ring_attention_bwd_world(
                                q, k, v, pout, plse, do, groups, causal=causal)
                            pgrads = attention.ring_attention_bwd_plain(
                                q, k, v, pout, plse, do, groups, causal=causal)
                            torch.cuda.synchronize()
                            case = f"{dtype} d={dh} sb={sb} {hq}/{hkv} causal={causal} groups={groups is not None}"
                            check_close(torch, f"{case} out", out, pout, dtype)
                            check_close(torch, f"{case} lse", lse, plse, torch.float32)
                            for nm, a, b in zip(("dq", "dk", "dv"), grads, pgrads):
                                check_close(torch, f"{case} {nm}", a, b, dtype)
                            n_cases += 2
    # contiguous bf16 views 8 bytes past a 16-byte boundary: the kernels stage
    # 16-byte chunks, so the wrapper must hand them an aligned copy
    views = [torch.randn(P * 4 * 48 * 128 + 4, device=dev, generator=gen)
             .to(torch.bfloat16)[4:].view(P, 4, 48, 128) for _ in range(3)]
    if any(t.data_ptr() % 16 != 8 for t in views):
        raise RuntimeError("the misaligned views are not 8 bytes past a boundary")
    out, lse = attention.ring_attention_world(*views, causal=True, with_lse=True)
    aout, alse = attention.ring_attention_world(*(t.clone() for t in views), causal=True,
                                                with_lse=True)
    torch.cuda.synchronize()
    if not (torch.equal(out, aout) and torch.equal(lse, alse)):
        raise RuntimeError("forward on views off 16 bytes != forward on aligned copies")
    check_close(torch, "bf16 views off 16 bytes: out", out,
                attention.ring_attention_plain(*views, causal=True), torch.bfloat16)
    record["attention_misaligned_view_forward"] = "bitwise equal to the aligned copies"
    record["attention_parity_cases"] = n_cases
    log(f"attention parity: {n_cases} cases (forward and backward) within tolerance")
    lap("attention parity")

    # 9. timing at the serving shape ---------------------------------------------
    shape = (P, SERVE["heads"], SERVE["kv_heads"], SERVE["seq_per_rank"], SERVE["d"])
    rep = SERVE["heads"] // SERVE["kv_heads"]
    entries = []
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        q, k, v = serve.pop(dtype)
        esz = q.element_size()
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_SPLIT_TF32_FLOPS
        do = torch.randn(q.shape, device=dev, generator=gen).to(dtype)
        out, lse = attention.ring_attention_world(q, k, v, causal=True, with_lse=True)
        pout, plse = attention.ring_attention_plain(q, k, v, causal=True, with_lse=True)
        errs[("fwd", dtype)] = max(errs[("fwd", dtype)], check_close(
            torch, f"{tag} forward at the serving shape: out", out, pout, dtype))
        lse_err = check_close(torch, f"{tag} forward at the serving shape: lse", lse, plse,
                              torch.float32)
        record.setdefault("serving_shape_forward_max_abs_err", {})[tag] = {
            "out": errs[("fwd", dtype)], "lse": lse_err}
        log(f"{tag} forward at the serving shape: max abs err out "
            f"{errs[('fwd', dtype)]:.3g}, lse {lse_err:.3g}")
        del pout, plse
        ops = attention.bwd_operands(q, k, v, out, lse, do, causal=True)
        got = attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=True)
        want = attention.ring_attention_bwd_plain(q, k, v, out, lse, do, causal=True)
        errs[("bwd_dq", dtype)] = check_close(torch, f"{tag} dq", got[0], want[0],
                                              dtype, normwise=True)
        errs[("bwd_dkv", dtype)] = max(
            check_close(torch, f"{tag} dk", got[1], want[1], dtype, normwise=True),
            check_close(torch, f"{tag} dv", got[2], want[2], dtype, normwise=True))
        log(f"{tag} backward at the serving shape: max abs err dq "
            f"{errs[('bwd_dq', dtype)]:.3g}, dk/dv {errs[('bwd_dkv', dtype)]:.3g}; "
            f"max |plain| dq {float(want[0].float().abs().max()):.4g}, dk "
            f"{float(want[1].float().abs().max()):.4g}, dv "
            f"{float(want[2].float().abs().max()):.4g}")
        again = attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=True)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{tag} backward: two launches differ (not deterministic)")
        log(f"{tag} backward at the serving shape: two launches bitwise equal")
        record.setdefault("deterministic", {})[tag] = True
        del got, want, again
        t = {
            "fwd": time_ms(torch, lambda: attention.ring_attention_world(
                q, k, v, causal=True, with_lse=True), reps=5, warmup=1),
            "bwd": time_ms(torch, lambda: attention.ring_attention_bwd_world(
                q, k, v, out, lse, do, causal=True), reps=5, warmup=1),
            "bwd_dq": time_ms(torch, lambda: attention.launch_bwd("bwd_dq", ops),
                              reps=5, warmup=1),
            "bwd_dkv": time_ms(torch, lambda: attention.launch_bwd("bwd_dkv", ops),
                               reps=5, warmup=1),
            "plain_fwd": time_ms(torch, lambda: attention.ring_attention_plain(
                q, k, v, causal=True, with_lse=True), reps=3, warmup=0),
            "plain_bwd": time_ms(torch, lambda: attention.ring_attention_bwd_plain(
                q, k, v, out, lse, do, causal=True), reps=3, warmup=0),
        }
        # the yardstick: one library call over the whole sequence
        ql, kl, vl, dol = (world_to_sequence(a) for a in (q, k, v, do))
        gqa = dtype == torch.bfloat16
        if not gqa:  # the float32 kernels take expanded heads
            kl, vl = kl.repeat_interleave(rep, 1), vl.repeat_interleave(rep, 1)
        ql.requires_grad_(True)
        kl.requires_grad_(True)
        vl.requires_grad_(True)
        backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]

        def sdpa():
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                      enable_gqa=gqa)

        def sdpa_fwd_bwd():
            o = sdpa()
            return torch.autograd.grad(o, (ql, kl, vl), dol)

        with torch.no_grad():
            t["library_fwd"] = time_ms(torch, sdpa, reps=5, warmup=1)
        t["library_fwd_bwd"] = time_ms(torch, sdpa_fwd_bwd, reps=5, warmup=1)
        o_lib = sdpa()  # the backward alone, from this forward's saved outputs
        t["library_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
            o_lib, (ql, kl, vl), dol, retain_graph=True), reps=5, warmup=1)
        t["library_variant"] = "enable_gqa" if gqa else "K/V heads repeated"
        del o_lib, ql, kl, vl, dol
        io = {"fwd": ({"q": 1, "kv": 2}, {"q": 1, "rows": 1}),
              "bwd": ({"q": 3, "kv": 2, "rows": 1}, {"q": 1, "kv": 2}),
              "bwd_dq": ({"q": 2, "kv": 2, "rows": 2}, {"q": 1}),
              "bwd_dkv": ({"q": 2, "kv": 2, "rows": 2}, {"kv": 2})}
        for kind, (reads, writes) in io.items():
            bound, by, nbytes = attention_bound(kind, esz, peak, shape, reads, writes)
            t[f"{kind}_bound_ms"], t[f"{kind}_bound_by"] = bound, by
            t[f"{kind}_bytes"] = nbytes
            t[f"{kind}_pct_of_bound"] = 100.0 * bound / t[kind]
            t[f"{kind}_tflops"] = (FLOPS_PER_ENTRY[kind] * shape[4] * causal_entries(shape)
                                   / (t[kind] * 1e-3) / 1e12)
            key, rate = ("bf16", BF16_FLOPS) if dtype == torch.bfloat16 else ("f32", TF32_FLOPS)
            t[f"{kind}_design_floor_ms"] = (FLOOR_FLOPS_PER_ENTRY[key][kind] * shape[4]
                                            * causal_entries(shape) / rate * 1e3)
        timing[tag] = t
        log(f"attention timing {tag}: " + ", ".join(
            f"{key} {val:.3f}" if isinstance(val, float) else f"{key} {val}"
            for key, val in t.items() if not key.endswith("_bytes")))
        del q, k, v, do, out, lse, ops
        torch.cuda.empty_cache()
    record["attention_timing"] = timing
    record["attention_launches_main_path"] = main_launches
    record["allowance_used"] = dict(ALLOWANCE_USED)
    log(f"largest share of the allowance used: {ALLOWANCE_USED}")
    lap("attention timing")

    bt = timing["bfloat16"]
    for kind in ("fwd", "bwd_dq", "bwd_dkv"):
        entries.append({
            "name": f"attention_{kind}", "route": "cuda", "source": ATTN_SOURCE[kind],
            "replaces": ATTN_REPLACES[kind], "launches": main_launches[kind],
            "max_abs_err": errs[(kind, torch.bfloat16)], "ms": bt[kind],
            "plain_ms": bt["plain_fwd"] if kind == "fwd" else bt["plain_bwd"],
            "bound_ms": bt[f"{kind}_bound_ms"], "bound_by": bt[f"{kind}_bound_by"],
            # SDPA's backward computes dq, dk and dv in one call
            "library_ms": bt["library_fwd"] if kind == "fwd" else bt["library_bwd"],
            "library_call": "SDPA forward" if kind == "fwd" else
            "SDPA backward (dq, dk and dv together)",
            "library_fwd_bwd_ms": bt["library_fwd_bwd"],
            "pct_of_bound": bt[f"{kind}_pct_of_bound"], "tflops": bt[f"{kind}_tflops"],
            "design_floor_ms": bt[f"{kind}_design_floor_ms"], "dtype": "bfloat16",
        })
    return entries


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mpi_tpu_torch
    from mpi_tpu_torch import _build
    from mpi_tpu_torch.examples.jacobi import jacobi_program
    from mpi_tpu_torch.gpu import ring

    dev = torch.device("cuda", 0)
    record = {"card": card_line(), "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"card: {record['card']}")
    # a float32 product must stay float32 (TF32 would leave the tolerances)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lap("card")

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    record["build_s"] = {k: round(v, 2) for k, v in built.items()}
    log(f"build: {record['build_s']} (wall {time.perf_counter() - t0:.2f} s)")
    record["ptxas"] = ptxas_table(_build.PTXAS_REPORT)
    for row in record["ptxas"]:
        log(f"  ptxas {row['source']}: {row.get('kernel', row['function'])}: "
            f"{row.get('registers')} registers, spill stores {row.get('spill_stores')} "
            f"bytes, loads {row.get('spill_loads')} bytes")
    lap("build")

    # 2. Jacobi on the card vs the CPU ------------------------------------------
    jk = dict(rows_per_rank=128, cols=1024, iters=50)
    blk_g, res_g = mpi_tpu_torch.run(jacobi_program, nranks=P, **jk)
    blk_c, res_c = mpi_tpu_torch.run(jacobi_program, nranks=P, device="cpu", **jk)
    jerr = float((blk_g.cpu() - blk_c).abs().max())
    if not (torch.isfinite(blk_g).all() and jerr <= 1e-6 and
            abs(float(res_g[0]) - float(res_c[0])) <= 1e-6):
        raise RuntimeError(f"jacobi on the card disagrees with the CPU: {jerr}")
    record["jacobi"] = {"shape": list(blk_g.shape), "max_abs_err_vs_cpu": jerr,
                        "residual": float(res_g[0])}
    log(f"jacobi: {record['jacobi']}")
    lap("jacobi")

    # 3. the main path: north-star data-parallel step -----------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    base = torch.randn(NORTH_STAR_ELEMS, device=dev, generator=gen)

    def train_step(comm, base):
        grad = base * (1.0 + 0.125 * comm.rank.to(torch.float32))
        avg = comm.allreduce(grad, algorithm="pallas_ring")
        shard = comm.reduce_scatter(grad.view(comm.size, -1), algorithm="pallas_ring")
        params = comm.allgather(shard, algorithm="pallas_ring")
        return avg, shard, params

    ring.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg, shard, params = mpi_tpu_torch.run(train_step, base, nranks=P)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(ring.LAUNCHES)
    log(f"main path: step {step_s:.3f} s, launches {launches}")
    missing = [m for m, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"main path never launched the ring kernel for {missing}")

    scale = 1.0 + 0.125 * torch.arange(P, device=dev, dtype=torch.float32)
    grad_w = base[None] * scale[:, None]
    errs = {}
    checks = (("allreduce", avg, lambda: ring.allreduce_plain(grad_w)),
              ("reduce_scatter", shard,
               lambda: ring.reduce_scatter_plain(grad_w.view(P, P, -1))),
              ("allgather", params, lambda: ring.allgather_plain(shard)))
    for mode, got, plain in checks:
        want = plain()
        if not torch.equal(got, want):
            raise RuntimeError(f"main path {mode} differs from the plain version")
        errs[mode] = float((got - want).abs().max())
        del want
    head = grad_w[:, :1 << 20].double().sum(0)
    if not (torch.isfinite(avg).all() and
            torch.allclose(avg[0, :1 << 20].double(), head, rtol=1e-5, atol=1e-5) and
            torch.equal(avg[0], avg[-1])):
        raise RuntimeError("north-star allreduce disagrees with the float64 sum")
    record["main_path"] = {"step_s": step_s, "launches": launches,
                           "bytes_per_rank": NORTH_STAR_ELEMS * 4}
    del avg, shard, params, grad_w, base
    lap("data-parallel step")

    # 4. kernel vs plain, every mode x dtype x op x grouping --------------------
    groupings = {"world": None, "2x4": [[0, 1, 2, 3], [4, 5, 6, 7]]}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for gname, groups in groupings.items():
            g = P if groups is None else 4
            for op in ("sum", "max", "min"):
                for n in (1001, 600_001, 600_064):
                    x = spread_data(torch, gen, (P, n), dev)
                    if op != "sum":
                        x[1, 5] = float("nan")
                    x = x.to(dtype)
                    b = n // g
                    xs = x[:, :g * b].reshape(P, g, b).contiguous()
                    xb = x[:, :b].contiguous()
                    for mode, got, want in (
                            ("allreduce", ring.allreduce_world(x, groups, op),
                             ring.allreduce_plain(x, groups, op)),
                            ("reduce_scatter", ring.reduce_scatter_world(xs, groups, op),
                             ring.reduce_scatter_plain(xs, groups, op)),
                            ("allgather", ring.allgather_world(xb, groups),
                             ring.allgather_plain(xb, groups))):
                        torch.cuda.synchronize()
                        if not nan_equal(torch, got, want):
                            raise RuntimeError(
                                f"kernel != plain: {mode} {dtype} {op} {gname} n={n}")
                        n_cases += 1
    record["parity_cases"] = n_cases
    log(f"parity: {n_cases} cases bitwise equal")
    lap("ring parity")

    # 5. timing at the north-star sizes -------------------------------------------
    itemsize = 4
    block = NORTH_STAR_ELEMS // P
    timing = {}
    x = spread_data(torch, gen, (P, NORTH_STAR_ELEMS), dev)
    out = torch.empty_like(x)
    copy_ms = time_ms(torch, lambda: out.copy_(x))
    copy_gbps = 2 * x.numel() * itemsize / (copy_ms * 1e-3) / 1e9
    record["d2d_copy"] = {"bytes": x.numel() * itemsize, "ms": copy_ms, "GBps": copy_gbps}
    log(f"d2d copy: {copy_ms:.3f} ms, {copy_gbps:.1f} GB/s (read+write)")

    xs = x.view(P, P, block)
    xb = x[:, :block].contiguous()

    def lib_allreduce():
        out.copy_(torch.sum(x, 0).expand_as(x))

    modes = {
        "allreduce": dict(
            kernel=lambda: ring.allreduce_world(x), plain=lambda: ring.allreduce_plain(x),
            library=lib_allreduce, nbytes=2 * P * NORTH_STAR_ELEMS * itemsize,
            ops=(P - 1) * NORTH_STAR_ELEMS),
        # the rank axis of [P(ranks), P(blocks), block] is dim 0
        "reduce_scatter": dict(
            kernel=lambda: ring.reduce_scatter_world(xs),
            plain=lambda: ring.reduce_scatter_plain(xs),
            library=lambda: torch.sum(xs, 0),
            nbytes=(P * P * block + P * block) * itemsize,
            ops=(P - 1) * P * block),
        "allgather": dict(
            kernel=lambda: ring.allgather_world(xb),
            plain=lambda: ring.allgather_plain(xb),
            library=lambda: xb.repeat(P, 1, 1),
            nbytes=(P * block + P * P * block) * itemsize, ops=0),
    }
    kernels = []
    for mode, m in modes.items():
        got, want = m["kernel"](), m["plain"]()
        if not torch.equal(got, want):
            raise RuntimeError(f"{mode} kernel != plain at the north-star size")
        del got, want
        turns = {"kernel": [], "library": []}  # (one at a time, back to back)
        for _ in range(2):  # in turns: kernel, library, library, kernel
            for side in ("kernel", "library", "library", "kernel"):
                turns[side].append((time_ms(torch, m[side]), time_b2b(torch, m[side])))
        (k_ms, k_b2b), (l_ms, l_b2b) = (
            tuple(statistics.median(t[j] for t in turns[side]) for j in (0, 1))
            for side in ("kernel", "library"))
        p_ms = time_ms(torch, m["plain"])
        byte_ms = m["nbytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = m["ops"] / F32_FLOPS * 1e3
        bound_ms = max(byte_ms, op_ms)
        entry = {
            "name": f"ring_{mode}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[mode],
            "max_abs_err": errs[mode], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": l_ms,
            "bytes": m["nbytes"], "GBps": m["nbytes"] / (k_ms * 1e-3) / 1e9,
            "pct_of_bound": 100.0 * bound_ms / k_ms,
            "ms_b2b": k_b2b, "library_ms_b2b": l_b2b,
            "pct_of_bound_b2b": 100.0 * bound_ms / k_b2b,
            "ms_turns": turns["kernel"], "library_ms_turns": turns["library"],
        }
        kernels.append(entry)
        fmt = lambda ts: ", ".join(f"{a:.4f}/{b:.4f}" for a, b in ts)
        log(f"{mode} (one at a time/back to back): kernel {k_ms:.4f}/{k_b2b:.4f} ms "
            f"({fmt(turns['kernel'])}), library {l_ms:.4f}/{l_b2b:.4f} ms "
            f"({fmt(turns['library'])}), plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({entry['pct_of_bound']:.1f}/{entry['pct_of_bound_b2b']:.1f}% of bound, "
            f"{entry['GBps']:.1f} GB/s one at a time)")
    del x, out, xs, xb
    lap("ring timing")

    # 6-9. ring attention -------------------------------------------------------
    attn = attention_phases(torch, dev, gen, record)
    kernels += attn
    record["kernels"] = kernels

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(record["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
