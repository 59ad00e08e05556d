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
   {SUM, MAX, MIN} x {whole world, 2 groups of 4, the dry run's dp groups
   of 2 at stride 4} at ragged and aligned small sizes;
5. the multi-parallel dry run, ``mpi_tpu_torch.entry.dryrun_multichip(8)``
   on the card with the reference's shapes (a 2 x 4 layout, then the 1-D
   attention leg against its float64 oracle).  Counters zeroed before and
   read after: the attention forward and both backward kernels must have
   launched;
6. the full-width multi-parallel step: one ``entry._build_step(2, 4, ...)``
   step at Llama-3-8B's MLP widths (``meta-llama/Meta-Llama-3-8B``
   ``config.json``: hidden_size 4096, intermediate_size 14336, so 3584 per
   mp rank), 2048 rows per dp shard, float32, the reference's init (x, y
   ~ N(0, 1), weights 0.1 N(0, 1)), once with ``dp_algorithm="ring"`` and
   once with ``"pallas_ring"``, whose ring kernel must launch on the dp
   groups [[0, 4], [1, 5], [2, 6], [3, 7]] (counters and the groups it was
   handed).  The two spellings agree within rtol 1e-5, atol 1e-6
   (``tests/test_dryrun.py:63-65``), and each agrees with a float64 dense
   step on the card: the loss within rtol 1e-5, the w1 and w2 updates
   within 1e-2 of their norm (relu kinks under float32 rounding, see
   ``step_phase``; the largest share of each allowance is recorded); a
   second step takes the first one's outputs.  Then the step is timed by both spellings with CUDA events
   (median of 5 after 1 warm-up; pallas_ring also by
   ``mpi_tpu_torch.profiling.timeit``), the ring kernel alone on the step's
   gradient (its share of the step), the fused SUM backward's rule alone
   and the step with it against the step with the old pass-through rule
   (in turns), and one pallas_ring step is traced with
   ``profiling.trace``, whose Chrome trace is read back
   (``profiling.trace_summary``: device time by kernel, the device's busy
   time and idle share, kernel launches counted apart from copies and
   fills);
6a. checkpoint: the full-width step's w1 and w2 after step 1, laid out as
   the reference's out_specs over the 2 x 4 mesh, through
   ``checkpoint.save_sharded`` under chiprun_out/ and ``load_sharded``
   onto the card; step 2 from the loaded state equals step 2 from the
   state in memory, bitwise (bytes, save and load seconds printed; the
   files are removed after);
6b. AOT: ``entry.lower_multichip(8)`` at the reference's shapes on fake
   tensors (no change in allocated device memory; the pallas_ring graph
   holds one ``ring_fold`` node and ``attn_fwd`` nodes), then
   ``entry.export_multichip(8, "pallas_ring")`` at full width through
   ``torch.export.save`` / ``load``: the loaded program's outputs equal the
   eager step's bitwise and it launches K1 and K2 (counters zeroed before
   and read after); both timed with CUDA events (median of 5);
6c. gradient: the fused SUM's gradient where the reduced value meets
   rank-varying values (marked by ``comm.localize``), in a residual block,
   and where it feeds replicated computation, on the card against the CPU
   (rtol 1e-5, atol 1e-6); the unmarked mixed program raises naming
   ``comm.localize`` on both;
7. the examples ``jacobi2d``, ``pipeline``, ``moe``, ``ulysses_attention``
   and ``data_parallel`` through ``run(..., nranks=8)`` on the card at
   their default sizes, each against the same program on the CPU (the
   programs that draw with ``rank_normal`` on the card's draws, carried
   across), moe and pipeline also against their numpy oracles (see each
   ``agree`` call for its tolerance);
8. timing with CUDA events at the north-star sizes: the kernel and one
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
9. ring attention, serving leg: a per-rank program that draws its Q/K/V
   with ``mpi_tpu_torch.rank_normal`` and calls
   ``mpi_tpu_torch.gpu.attention.ring_attention``, through ``run(...,
   nranks=8)``, at Llama-3-8B's attention geometry (32 query heads, 8 K/V
   heads, head dim 128; ``meta-llama/Meta-Llama-3-8B`` ``config.json``)
   over a causal sequence of 32 768 (4096 rows per rank), bfloat16 and then
   float32.  The forward kernel must have launched; the output must agree
   with the plain version on the card (see ``check_close``);
10. ring attention, training leg: one ``sharded_train_step`` of
    ``mpi_tpu_torch.examples.long_context_training`` through ``run(...,
    nranks=8)`` at 4096 rows per rank, d = 128, float32, causal.  Every
    attention kernel must have launched; loss and gradients must agree with
    the dense one-device step on the card (the tolerances of
    ``tests/test_long_context.py:180-185``);
11. attention kernels vs plain versions on the card: {float32, bfloat16} x
    {full, causal} x {MHA 4/4, GQA 4/2, MQA 4/1} x {world of 8, 2 groups of
    4} x Sb in {16, 48, 112, 128} (and 8, the dry run's block, in float32)
    x d in {128, 256}, forward (out and lse) and backward (dq, dk, dv),
    with the tolerances of ``check_close`` (Sb = 8, 16, 48 and 112 end in
    a partial tile);
12. attention at the serving shape, in bfloat16 (the ``kernels`` line) and
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
13. host-local: the host layer's local backend, 8 rank threads on the
    card through ``run(..., backend="local", nranks=8)``, 256 MiB of seeded
    normal float32 per rank: allreduce by ``ring``, ``recursive_halving``,
    ``rabenseifner`` and ``reduce_bcast``, reduce_scatter, allgather
    (``ring`` and ``doubling``, 32 MiB per rank in), bcast (the segmented
    tree) and alltoall.  Each result is held bitwise across ranks (or
    against the copies it must be), bitwise against the same program run
    by the same engine with ``device="cpu"`` in this process, and the
    reductions within rtol 1e-5, atol 1e-5 of a float64 sum; each
    collective's median ms over 3 timed calls after 1 warm-up (a
    synchronize before the clock stops, the slowest rank's time) and its
    bandwidth; one ring allreduce traced with ``profiling.trace`` for the
    card's busy share;
14. host-socket: ``python -m mpi_tpu_torch.launcher -n 4
    mpi_tpu_torch/examples/host_allreduce.py`` — 4 rank processes on the
    card over loopback TCP: ring and Rabenseifner allreduce at 256 MiB per
    rank (every rank regenerates every input for a float64 check and
    matches rank 0 bitwise, and the ``bytes_pickled_sent`` pvar must not
    move), a 1 KiB float32 allreduce on 2 ranks (the ``BASELINE.json``
    latency config), and the examples of phase 15 as socket ranks;
15. the examples ``pi`` and ``jacobi``, unmodified, under
    ``backend="local"`` on the card and as the launcher's socket ranks,
    against their SPMD results on the card (bitwise);
16. one ``{"kernels": [...]}`` JSON line, then the ok line.  Each kernel's
    ``launches`` is the sum over the main paths (phases 3, 5, 6, 6b, 9,
    10), each read right after it ran (``launches_by_path``).  The host
    layer launches none of the kernels: its folds are in-place torch ops.

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
# K1's parity groupings: the whole world, two contiguous groups of four, and
# the dp groups of the 2 x 4 layout of the multi-parallel step (stride 4)
DP_GROUPS = [[0, 4], [1, 5], [2, 6], [3, 7]]
RING_GROUPINGS = {"world": None, "2x4": [[0, 1, 2, 3], [4, 5, 6, 7]],
                  "4x2 stride 4": DP_GROUPS}
# the full-width step: Llama-3-8B's MLP (meta-llama/Meta-Llama-3-8B
# config.json: hidden_size 4096, intermediate_size 14336) on the 2 x 4
# layout, 2048 rows per dp shard, float32
STEP = dict(dp=2, mp=4, rows_per_shard=2048, d=4096, hidden=14336)


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


def attention_launches(attention):
    return {f"attention_{k}": c for k, c in attention.LAUNCHES.items()}


def ring_launches(ring):
    return {f"ring_{m}": c for m, c in ring.LAUNCHES.items()}


def attention_phases(torch, dev, gen, record, paths):
    """Phases 9-12; returns the three attention entries of the kernels line
    and adds the serving and training legs' launches to ``paths``."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import mpi_tpu_torch
    from mpi_tpu_torch.examples import long_context_training as lct
    from mpi_tpu_torch.gpu import attention

    errs = {}

    # 9. serving leg at full width ---------------------------------------------
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
        paths[f"serving leg {tag}"] = attention_launches(attention)
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

    # 10. training leg at the example's width ------------------------------------
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
    paths["training leg"] = attention_launches(attention)
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

    # 11. kernel vs plain grid --------------------------------------------------
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (128, 256):
            # Sb = 8 (float32 only: bf16 blocks are multiples of 16) is the
            # dry run's [8, 128] block
            for sb in (8, 16, 48, 112, 128) if dtype == torch.float32 else (16, 48, 112, 128):
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

    # 12. timing at the serving shape --------------------------------------------
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
    record["allowance_used"] = dict(ALLOWANCE_USED)
    log(f"largest share of the allowance used: {ALLOWANCE_USED}")
    lap("attention timing")

    bt = timing["bfloat16"]
    for kind in ("fwd", "bwd_dq", "bwd_dkv"):
        entries.append({
            "name": f"attention_{kind}", "route": "cuda", "source": ATTN_SOURCE[kind],
            "replaces": ATTN_REPLACES[kind],
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


def agree(torch, name, got, want, rtol, atol, record):
    """``got`` (card) within ``atol + rtol |want|`` of ``want``; records
    the max abs error and the largest share of the allowance used."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise RuntimeError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} "
                           f"or non-finite values")
    diff = (g - w).abs()
    share = float((diff / (atol + rtol * w.abs())).max()) if diff.numel() else 0.0
    record[name] = {"max_abs_err": float(diff.max()) if diff.numel() else 0.0,
                    "allowance_share": share, "rtol": rtol, "atol": atol}
    if share > 1.0:
        raise RuntimeError(f"{name}: max abs error {float(diff.max())} exceeds "
                           f"rtol {rtol} atol {atol} ({share:.3g} of the allowance)")
    return record[name]["max_abs_err"]


def agree_update(torch, name, got, want, before, tol, record):
    """The update ``got - before`` within ``tol`` of ``want - before`` in
    relative 2-norm: ||got - want|| <= tol ||want - before||."""
    g, w, b = (t.detach().double() for t in (got, want, before))
    err = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w - b))
    record[name] = {"relative_update_err": err, "allowance_share": err / tol, "tol": tol,
                    "max_abs_err": float((g - w).abs().max())}
    if not err <= tol:
        raise RuntimeError(f"{name}: update off by {err:.3g} of its norm (tolerance {tol})")
    return err


def dryrun_phase(torch, paths, record):
    """Phase 5: ``entry.dryrun_multichip(8)`` on the card, the reference's
    shapes; the attention kernels (forward and both backward) must have
    launched."""
    import contextlib
    import io

    from mpi_tpu_torch import entry
    from mpi_tpu_torch.gpu import attention, ring

    ring.reset_launches()
    attention.reset_launches()
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        entry.dryrun_multichip(P)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {**ring_launches(ring), **attention_launches(attention)}
    missing = [k for k in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv")
               if launches[k] == 0]
    if missing:
        raise RuntimeError(f"dry run never launched {missing}")
    paths["dry run"] = launches
    line = out.getvalue().strip().splitlines()[-1]
    if not line.startswith("dryrun_multichip OK: mesh=(2x4)") or "cuda_kernels(" not in line:
        raise RuntimeError(f"dry run printed {line!r}")
    record["dry_run"] = {"line": line, "run_s": run_s, "launches": launches}
    log(f"{line} ({run_s:.3f} s, launches {launches})")


def step_phase(torch, dev, paths, record):
    """Phase 6: one step of ``entry._build_step(2, 4, ...)`` at Llama-3-8B's
    MLP widths, as "ring" and as "pallas_ring" (K1 on the dp groups); the
    two agree, and both agree with a float64 dense step on the card; a
    second step takes the first one's outputs; then timing (CUDA events,
    median of 5 after 1 warm-up, and ``profiling.timeit``), K1 alone on
    the step's gradient, the fused SUM backward's cost, and a breakdown of
    one pallas_ring step read back from the trace ``profiling.trace``
    wrote.  Returns the two steps and their inputs."""
    from mpi_tpu_torch import entry, profiling
    from mpi_tpu_torch.gpu import attention, ring

    dp, mp, rows, d, hidden = (STEP[k] for k in ("dp", "mp", "rows_per_shard", "d",
                                                 "hidden"))
    gen = torch.Generator(device=dev).manual_seed(5)
    # the reference's init: x, y ~ N(0, 1), w1, w2 ~ 0.1 N(0, 1)
    x, y = (torch.randn((dp * rows, d), device=dev, generator=gen) for _ in range(2))
    w1 = torch.randn((d, hidden), device=dev, generator=gen) * 0.1
    w2 = torch.randn((hidden, d), device=dev, generator=gen) * 0.1
    info = {"shapes": {"x": list(x.shape), "w1": list(w1.shape), "w2": list(w2.shape)}}
    outs, steps = {}, {}
    fold_calls = []
    fold = ring.allreduce_world

    def spy(world, groups=None, *args, **kwargs):  # records what K1 folds
        fold_calls.append((groups, list(world.shape)))
        return fold(world, groups, *args, **kwargs)

    for alg in ("ring", "pallas_ring"):
        step = steps[alg] = entry._build_step(dp, mp, dp_algorithm=alg)
        ring.reset_launches()
        attention.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring.allreduce_world = spy
        try:
            out = step(x, y, w1, w2)
        finally:
            ring.allreduce_world = fold
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        paths[f"full-width step ({alg})"] = {**ring_launches(ring),
                                             **attention_launches(attention)}
        info[alg] = {"first_step_s": first_s, "launches": paths[f"full-width step ({alg})"],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "loss": float(out[2])}
        again = step(x, y, out[0], out[1])  # the step takes its own outputs
        if not all(bool(torch.isfinite(t).all()) for t in (*out, *again)):
            raise RuntimeError(f"full-width step ({alg}) produced non-finite values")
        info[alg]["second_loss"] = float(again[2])
        outs[alg] = out
        del again
    k1 = paths["full-width step (pallas_ring)"]["ring_allreduce"]
    if k1 == 0 or paths["full-width step (ring)"]["ring_allreduce"] != 0:
        raise RuntimeError("K1 must launch in the pallas_ring step and only there")
    if [g for g, _ in fold_calls] != [DP_GROUPS] * k1:
        raise RuntimeError(f"K1 folded groups {fold_calls}, not {DP_GROUPS}")
    info["k1_fold_calls"] = fold_calls
    for name, a, b in zip(("w1", "w2", "loss", "aux"), outs["ring"], outs["pallas_ring"]):
        agree(torch, f"step {name}: pallas_ring vs ring", b, a, 1e-5, 1e-6, info)

    # the float64 dense step on one device: one SGD step (lr 0.1) on the sum
    # over the dp shards of their mean squared errors, the reference's step.
    # The loss is held elementwise (rtol 1e-5); the weights by their update
    # in relative 2-norm (1e-2): float32 rounding of x @ w1 (error about
    # 2.4e-5 on values of spread 6.4, K = 4096) flips about 200 of the 58.7M
    # relu mask entries, each moving a column of the w1 gradient by about
    # 8e-5 times a row of x: an expected 2-3e-3 of the update's norm, and
    # up to 3e-5 on single elements of w1 (measured on an H100)
    X, Y, W1, W2 = (t.double() for t in (x, y, w1, w2))
    xs, ys = X.view(dp, rows, d), Y.view(dp, rows, d)

    def total_loss(a, b):
        return ((torch.relu(xs @ a) @ b - ys) ** 2).mean(dim=(1, 2)).sum()

    g1, g2 = torch.func.grad(total_loss, argnums=(0, 1))(W1, W2)
    dense = (W1 - 0.1 * g1, W2 - 0.1 * g2, total_loss(W1, W2))
    for alg in ("ring", "pallas_ring"):
        for name, got, want, before in zip(("w1", "w2"), outs[alg], dense, (w1, w2)):
            agree_update(torch, f"step {name} update ({alg}) vs float64 dense", got, want,
                         before, 1e-2, info)
        agree(torch, f"step loss ({alg}) vs float64 dense", outs[alg][2], dense[2], 1e-5,
              0.0, info)
    del X, Y, W1, W2, xs, ys, g1, g2, dense, outs
    torch.cuda.empty_cache()

    # timing: the step by both spellings, K1 alone on the step's operand
    for alg, step in steps.items():
        info[alg]["step_ms"] = time_ms(torch, lambda: step(x, y, w1, w2), reps=5, warmup=1)
    g_world = torch.randn((P, d, hidden // mp), device=dev, generator=gen)
    info["k1_ms"] = time_ms(torch, lambda: ring.allreduce_world(g_world, DP_GROUPS),
                            reps=5, warmup=1)
    info["k1_share_of_pallas_ring_step"] = info["k1_ms"] / info["pallas_ring"]["step_ms"]
    del g_world
    info["pallas_ring"]["step_timeit_ms"] = profiling.timeit(
        lambda: steps["pallas_ring"](x, y, w1, w2), iters=5, warmup=1).p50_s * 1e3
    sum_backward_cost(torch, dev, steps["pallas_ring"], (x, y, w1, w2), info)
    torch.cuda.synchronize()
    trace_dir = os.path.join("chiprun_out", "step_trace")
    with profiling.trace(trace_dir):
        t0 = time.perf_counter()
        steps["pallas_ring"](x, y, w1, w2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # read back from the Chrome trace profiling.trace wrote: the device's
    # kernels, copies and fills (busy time), kernel launches counted apart
    summary = profiling.trace_summary(os.path.join(trace_dir, profiling.TRACE_FILE))
    busy = summary["busy_ms"]
    info["profile"] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                       "device_span_ms": summary["span_ms"],
                       "idle_share": (1.0 - busy / wall_ms) if busy else None,
                       "device_op_names": len(summary["by_name"]),
                       "kernel_launches": summary["kernel_launches"],
                       "copies_and_fills": summary["copies_and_fills"],
                       "source": os.path.join(trace_dir, profiling.TRACE_FILE),
                       "top": [{"op": k, "device_ms": t, "count": c}
                               for k, t, c in summary["by_name"][:15]]}
    record["full_width_step"] = info
    log(f"full-width step (D={d}, H={hidden}, {rows} rows per dp shard, 2 x 4): "
        f"first step ring {info['ring']['first_step_s']:.3f} s / pallas_ring "
        f"{info['pallas_ring']['first_step_s']:.3f} s; step ring "
        f"{info['ring']['step_ms']:.3f} ms, pallas_ring {info['pallas_ring']['step_ms']:.3f} ms; "
        f"(timeit {info['pallas_ring']['step_timeit_ms']:.3f} ms); "
        f"K1 alone {info['k1_ms']:.4f} ms ({100 * info['k1_share_of_pallas_ring_step']:.2f}% "
        f"of the pallas_ring step); peak {info['pallas_ring']['peak_bytes'] / 2**30:.2f} GiB; "
        f"profiled step (profiling.trace): wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms in {info['profile']['kernel_launches']} kernel launches and "
        f"{info['profile']['copies_and_fills']} copies and fills; SUM backward "
        f"{info['sum_backward']['rule_ms']:.4f} ms alone, step with the old rule "
        f"{info['sum_backward']['step_old_rule_ms']:.3f} ms vs "
        f"{info['sum_backward']['step_new_rule_ms']:.3f} ms")
    for row in info["profile"]["top"][:8]:
        log(f"  {row['device_ms']:9.3f} ms  x{row['count']:<4d} {row['op'][:90]}")
    log("  allowance shares: " + ", ".join(
        f"{k}: {v['allowance_share']:.3g}" for k, v in info.items()
        if isinstance(v, dict) and "allowance_share" in v))
    return steps, (x, y, w1, w2)


def sum_backward_cost(torch, dev, step, args, info):
    """What the fused SUM backward's rule costs in the full-width step: the
    rule alone on a cotangent of the tp allreduce's shape (``[P, rows,
    d]``, groups of the mp axis), and the step with it against the step
    with the rule it replaced (each cotangent passed through unchanged),
    timed in turns (new, old, old, new; CUDA events, median of 5 each)."""
    from mpi_tpu_torch.gpu import primitives

    dp, mp, rows, d = (STEP[k] for k in ("dp", "mp", "rows_per_shard", "d"))
    groups = list(range(P))  # the mp groups [[0, 1, 2, 3], [4, 5, 6, 7]], flattened
    gen = torch.Generator(device=dev).manual_seed(11)
    # as in the step, each mp group's cotangents are equal (else it raises)
    cot = torch.randn((P // mp, rows, d), device=dev, generator=gen).repeat_interleave(mp, 0)

    rule_ms = time_ms(torch, lambda: primitives.group_cotangent_world(cot, groups, mp),
                      reps=5, warmup=1)
    del cot
    new_backward = primitives._GroupReduce.backward

    def old_backward(ctx, grad):
        return grad, None, None, None, None

    turns = {"new": [], "old": []}
    for side in ("new", "old", "old", "new"):
        if side == "old":
            primitives._GroupReduce.backward = staticmethod(old_backward)
        try:
            turns[side].append(time_ms(torch, lambda: step(*args), reps=5, warmup=1))
        finally:
            primitives._GroupReduce.backward = staticmethod(new_backward)
    info["sum_backward"] = {
        "rule_ms": rule_ms, "cotangent_shape": [P, rows, d],
        "step_new_rule_ms": statistics.median(turns["new"]),
        "step_old_rule_ms": statistics.median(turns["old"]), "turns": turns}


def checkpoint_phase(torch, dev, steps, args, record):
    """The full-width step's state after step 1 (w1 and w2, laid out as
    the reference's out_specs P(None, "mp") and P("mp", None) over the 2 x
    4 mesh) through ``checkpoint.save_sharded`` under chiprun_out/ and
    ``load_sharded`` onto the card into a template; step 2 from the loaded
    state must equal step 2 from the state in memory, bitwise."""
    import shutil

    from mpi_tpu_torch.checkpoint import Layout, Sharded, load_sharded, save_sharded

    x, y, w1, w2 = args
    step = steps["pallas_ring"]
    w1n, w2n, _, _ = step(x, y, w1, w2)
    mesh = {"dp": STEP["dp"], "mp": STEP["mp"]}
    layouts = {"w1": Layout(mesh, (None, "mp")), "w2": Layout(mesh, ("mp", None))}
    state = {"w1": Sharded(w1n, layouts["w1"]), "w2": Sharded(w2n, layouts["w2"])}
    path = os.path.join("chiprun_out", "checkpoint")
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = save_sharded(path, state)
    save_s = time.perf_counter() - t0
    files = sum(len(f) for _, _, f in os.walk(path))
    template = {k: Sharded(torch.empty_like(v.tensor), layouts[k]) for k, v in state.items()}
    t0 = time.perf_counter()
    loaded = load_sharded(path, template)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(path)
    for k, v in state.items():
        got = loaded[k].tensor
        if got.device != dev or not torch.equal(got, v.tensor):
            raise RuntimeError(f"checkpoint: {k} came back different (on {got.device})")
    want = step(x, y, w1n, w2n)
    got = step(x, y, loaded["w1"].tensor, loaded["w2"].tensor)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("checkpoint: step 2 from the loaded state differs")
    record["checkpoint"] = {"bytes": nbytes, "files": files, "save_s": save_s,
                            "load_s": load_s,
                            "step2_from_loaded_state": "bitwise equal"}
    log(f"checkpoint: {nbytes} bytes in {files} files (shards and manifest), save "
        f"{save_s:.3f} s, load {load_s:.3f} s; step 2 from the loaded state bitwise "
        f"equal")


def aot_phase(torch, dev, steps, args, paths, record):
    """``entry.lower_multichip(8)`` at the reference's shapes on fake
    tensors (device memory allocated must not change; the pallas_ring
    graph must hold one ``ring_fold`` node and ``attn_fwd`` nodes), then
    ``entry.export_multichip(8, "pallas_ring")`` at full width through
    ``torch.export.save`` / ``load``: the loaded program's outputs must
    equal the eager step's bitwise, and running it must launch K1 and K2
    (counters zeroed before, read after); both timed with CUDA events
    (median of 5 after 1 warm-up)."""
    from mpi_tpu_torch import aot, entry
    from mpi_tpu_torch.gpu import attention, ring

    info = {}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    graph = entry.lower_multichip(P)
    info["lower_s"] = time.perf_counter() - t0
    graph_k = entry.lower_multichip(P, "pallas_ring")
    info["lower_allocated_bytes"] = torch.cuda.memory_allocated() - before
    info["lower_nodes"] = len(graph.graph.nodes)
    info["lower_kernel_nodes"] = {"ring": aot.kernel_nodes(graph),
                                  "pallas_ring": aot.kernel_nodes(graph_k)}
    if info["lower_allocated_bytes"] != 0:
        raise RuntimeError(f"lower_multichip allocated {info['lower_allocated_bytes']} bytes")
    nodes = info["lower_kernel_nodes"]["pallas_ring"]
    if nodes.get("ring_fold") != 1 or not nodes.get("attn_fwd"):
        raise RuntimeError(f"the lowered pallas_ring step holds kernel nodes {nodes}")
    del graph, graph_k

    shapes = tuple(tuple(t.shape) for t in args)
    t0 = time.perf_counter()
    program = entry.export_multichip(P, "pallas_ring", shapes=shapes)
    info["export_s"] = time.perf_counter() - t0
    info["export_kernel_nodes"] = aot.kernel_nodes(program.graph_module)
    nodes = info["export_kernel_nodes"]
    if nodes.get("ring_fold") != 1 or not nodes.get("attn_fwd"):
        raise RuntimeError(f"the exported step holds kernel nodes {nodes}")
    path = os.path.join("chiprun_out", "full_width_step.pt2")
    t0 = time.perf_counter()
    torch.export.save(program, path)
    loaded = torch.export.load(path).module()
    info["save_load_s"] = time.perf_counter() - t0
    info["pt2_bytes"] = os.path.getsize(path)
    os.remove(path)
    eager = steps["pallas_ring"](*args)
    ring.reset_launches()
    attention.reset_launches()
    torch.cuda.synchronize()
    out = loaded(*args)
    torch.cuda.synchronize()
    launches = {**ring_launches(ring), **attention_launches(attention)}
    if not launches["ring_allreduce"] or not launches["attention_fwd"]:
        raise RuntimeError(f"the exported step launched {launches}")
    paths["exported full-width step"] = launches
    info["launches"] = launches
    if not all(torch.equal(a, b) for a, b in zip(out, eager)):
        raise RuntimeError("the exported step's outputs differ from the eager step's")
    del out, eager
    info["exported_step_ms"] = time_ms(torch, lambda: loaded(*args), reps=5, warmup=1)
    info["eager_step_ms"] = time_ms(torch, lambda: steps["pallas_ring"](*args), reps=5,
                                    warmup=1)
    record["aot"] = info
    log(f"AOT: lower_multichip(8) {info['lower_s']:.3f} s, {info['lower_nodes']} nodes, "
        f"kernel nodes {info['lower_kernel_nodes']}, {info['lower_allocated_bytes']} bytes "
        f"allocated; export at full width {info['export_s']:.3f} s, kernel nodes "
        f"{nodes}, .pt2 {info['pt2_bytes']} bytes; loaded program bitwise equal to the "
        f"eager step, launches {launches}; step {info['exported_step_ms']:.3f} ms "
        f"exported vs {info['eager_step_ms']:.3f} ms eager")


def gradient_phase(torch, record):
    """The fused SUM's gradient on the card against the CPU, 8 ranks, numpy
    inputs (rtol 1e-5, atol 1e-6): the mixed program (the reduced value,
    marked by ``comm.localize``, times a rank-varying y: each rank's
    gradient is x_r times the sum of y), the residual block (h1 + the
    allreduce of localize(h1) times a rank-varying u) and the replicated
    one (the reduced value squared).  The mixed program without the mark
    must raise, naming ``comm.localize``, on the card as on the CPU."""
    import numpy as np

    import mpi_tpu_torch

    rng = np.random.RandomState(0)
    x, w, y = (rng.randn(P, 3).astype(np.float32) for _ in range(3))

    def mixed(comm, x, w, y, mark=True):
        def loss(v):
            r = comm.allreduce(x[comm.rank] * v, algorithm="fused")
            return torch.sum((comm.localize(r) if mark else r) * y[comm.rank])
        return torch.func.grad(loss)(w[comm.rank])

    def residual(comm, x, w, u):
        def loss(v):
            h1 = comm.allreduce(x[comm.rank] * v, algorithm="fused")
            h2 = h1 + comm.allreduce(comm.localize(h1) * u[comm.rank], algorithm="fused")
            return torch.sum(h2 ** 2)
        return torch.func.grad(loss)(w[comm.rank])

    def replicated(comm, x, w, y):
        return torch.func.grad(lambda v: torch.sum(comm.allreduce(
            x[comm.rank] * v, algorithm="fused") ** 2))(w[comm.rank])

    info = {}
    for name, prog in (("mixed", mixed), ("residual", residual),
                       ("replicated", replicated)):
        card = mpi_tpu_torch.run(prog, x, w, y, nranks=P)
        cpu = mpi_tpu_torch.run(prog, x, w, y, nranks=P, device="cpu")
        agree(torch, f"gradient {name}: card vs cpu", card, cpu, 1e-5, 1e-6, info)
        if name == "mixed":  # JAX's result: x_r times the sum of y
            agree(torch, "gradient mixed: card vs x * sum(y)", card,
                  torch.from_numpy(x * y.sum(0)), 1e-5, 1e-6, info)
    for dev in (None, "cpu"):
        try:
            mpi_tpu_torch.run(lambda c, *a: mixed(c, *a, mark=False), x, w, y,
                              nranks=P, device=dev)
        except RuntimeError as e:
            if "comm.localize" not in str(e):
                raise
        else:
            raise RuntimeError(f"the unmarked mixed program ran on {dev or 'the card'}")
    info["unmarked_mixed_raises"] = True
    record["gradient"] = info
    log("gradient programs on the card vs the CPU: " + ", ".join(
        f"{k} {v['max_abs_err']:.3g}" for k, v in info.items() if isinstance(v, dict))
        + "; the unmarked mixed program raises naming comm.localize on both")


def examples_phase(torch, record):
    """Phase 7: jacobi2d, pipeline, moe, ulysses and data_parallel through
    ``run(..., nranks=8)`` on the card at their default sizes, each against
    the same program on the CPU (the random ones on the card's draws,
    carried across) and moe / pipeline against their numpy oracles."""
    import mpi_tpu_torch
    from mpi_tpu_torch.examples import data_parallel as dpx
    from mpi_tpu_torch.examples import jacobi2d, moe, pipeline
    from mpi_tpu_torch.examples import ulysses_attention as ul

    run = mpi_tpu_torch.run
    info = {}

    def on_cpu(fn, *args):
        return run(fn, *(a.cpu() if isinstance(a, torch.Tensor) else
                         {k: v.cpu() for k, v in a.items()} for a in args),
                   nranks=P, device="cpu")

    tile, res = run(jacobi2d.jacobi2d_program, nranks=P)
    tile_c, res_c = run(jacobi2d.jacobi2d_program, nranks=P, device="cpu")
    agree(torch, "jacobi2d tiles vs cpu", tile, tile_c, 0.0, 1e-6, info)
    agree(torch, "jacobi2d residual vs cpu", res, res_c, 0.0, 1e-6, info)

    out = run(pipeline.pipeline_program, nranks=P)
    mx, w, b = run(pipeline.pipeline_inputs, nranks=P)
    agree(torch, "pipeline vs cpu", out, on_cpu(
        lambda c, mx, w, b: pipeline.pipeline_forward(c, mx[c.rank], w[c.rank], b[c.rank]),
        mx, w, b), 1e-5, 1e-6, info)
    agree(torch, "pipeline vs numpy oracle", out[-1], torch.from_numpy(
        pipeline.pipeline_oracle(*(t.cpu().numpy() for t in (mx[0], w, b)))), 0.0, 1e-5, info)

    out = run(moe.moe_program, nranks=P)
    xs, wr, wi, wo = run(moe.moe_inputs, nranks=P)
    agree(torch, "moe vs cpu", out, on_cpu(
        lambda c, x, wr, wi, wo: moe.moe_layer(c, x[c.rank], wr[c.rank], wi[c.rank],
                                               wo[c.rank], 8), xs, wr, wi, wo),
          1e-5, 1e-6, info)
    agree(torch, "moe vs numpy oracle", out, torch.from_numpy(moe.moe_oracle(
        *(t.cpu().numpy() for t in (xs, wr[0], wi, wo)), 8)), 0.0, 1e-5, info)

    out, q, k, v = run(ul.ulysses_program, nranks=P)
    agree(torch, "ulysses vs cpu", out, on_cpu(
        lambda c, q, k, v: ul.ulysses_attention(c, q[c.rank], k[c.rank], v[c.rank]),
        q, k, v), 1e-5, 1e-6, info)

    loss, ck = run(dpx.dp_train_program, nranks=P)
    params, x, y = run(dpx.dp_inputs, nranks=P)
    loss_c, ck_c = on_cpu(lambda c, p, x, y: dpx.dp_train(c, p, x[c.rank], y[c.rank]),
                          {n: t[0] for n, t in params.items()}, x, y)
    agree(torch, "data_parallel loss vs cpu", loss, loss_c, 1e-5, 0.0, info)
    agree(torch, "data_parallel checksum vs cpu", ck, ck_c, 1e-5, 0.0, info)
    info["data_parallel_loss"] = float(loss[0])
    record["examples"] = info
    log("examples on the card vs the CPU and the oracles: " + ", ".join(
        f"{k} {v['max_abs_err']:.3g} ({v['allowance_share']:.3g} of allowance)"
        for k, v in info.items() if isinstance(v, dict)))


HOST_SEED = 7


def _timed_program(torch, call):
    """A rank program: 1 warm-up and 3 timed calls of ``call(comm, xs)`` (a
    barrier and a synchronize before each, a synchronize before the clock
    stops); returns the last result and the rank's seconds."""
    def prog(comm, xs):
        call(comm, xs)
        secs, out = [], None
        for _ in range(3):
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(comm, xs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out, secs
    return prog


def host_local_phase(torch, record):
    """Phase 13: the local backend's collectives on the card at 256 MiB per
    rank, against the CPU and a float64 sum, timed."""
    import mpi_tpu_torch
    from mpi_tpu_torch import profiling
    from mpi_tpu_torch.examples.host_allreduce import rank_input

    dev = torch.device("cuda", 0)
    card = card_line()
    n, numel = P, NORTH_STAR_ELEMS
    nbytes = numel * 4
    xs = [rank_input(r, numel, HOST_SEED, dev) for r in range(n)]
    xs_cpu = [x.cpu() for x in xs]
    want = torch.zeros(numel, dtype=torch.float64, device=dev)
    for x in xs:
        want += x.double()
    shard = numel // n
    # name -> (call, bytes the bandwidth counts, its bus factor)
    colls = {f"allreduce {a}": (lambda c, xs, a=a: c.allreduce(xs[c.rank], algorithm=a),
                                nbytes, 2 * (n - 1) / n)
             for a in ("ring", "recursive_halving", "rabenseifner", "reduce_bcast")}
    colls["reduce_scatter"] = (lambda c, xs: c.reduce_scatter(xs[c.rank].view(n, -1)),
                               nbytes, (n - 1) / n)
    for a in ("ring", "doubling"):
        colls[f"allgather {a}"] = (
            lambda c, xs, a=a: c.allgather(xs[c.rank][:shard], algorithm=a),
            nbytes, (n - 1) / n)
    colls["bcast tree"] = (lambda c, xs: c.bcast(xs[0] if c.rank == 0 else None, root=0),
                           nbytes, 1.0)
    # the blocks as one [P, N/P] tensor: the result comes back stacked
    colls["alltoall"] = (lambda c, xs: c.alltoall(xs[c.rank].view(n, -1)),
                         nbytes, (n - 1) / n)

    def expect(name, r, got):
        """The check of rank r's result beyond card == CPU: copies must be
        the inputs exactly; reductions agree across ranks bitwise and with
        the float64 sum."""
        if name.startswith("allreduce"):
            return (torch.equal(got, results[0]) and torch.allclose(
                got.double(), want, rtol=1e-5, atol=1e-5))
        if name == "reduce_scatter":
            return torch.allclose(got.double(), want.view(n, -1)[r], rtol=1e-5, atol=1e-5)
        if name.startswith("allgather"):
            return torch.equal(got, torch.stack([x[:shard] for x in xs]))
        if name == "bcast tree":
            return torch.equal(got, xs[0])
        return torch.equal(got, torch.stack([x.view(n, -1)[r] for x in xs]))

    info = {"card": card, "ranks": n, "bytes_per_rank": nbytes}
    for name, (call, nb, factor) in colls.items():
        outs = mpi_tpu_torch.run(_timed_program(torch, call), xs, backend="local", nranks=n)
        results = [o for o, _ in outs]
        secs = [max(ts[i] for _, ts in outs) for i in range(3)]
        bad = [r for r, got in enumerate(results) if not expect(name, r, got)]
        if bad:
            raise RuntimeError(f"host-local {name}: ranks {bad} fail their check")
        cpu = mpi_tpu_torch.run(lambda c, xs: call(c, xs), xs_cpu, backend="local",
                                nranks=n, device="cpu")
        if not all(torch.equal(results[r].cpu(), cpu[r]) for r in range(n)):
            raise RuntimeError(f"host-local {name}: the card differs from the CPU")
        med = statistics.median(secs)
        err = (float((results[0].double() - want).abs().max())
               if name.startswith("allreduce") else 0.0)
        info[name] = {"s": secs, "median_ms": med * 1e3,
                      "algbw_GBps": nb / med / 1e9, "busbw_GBps": factor * nb / med / 1e9,
                      "bus_factor": factor, "max_abs_err_vs_f64": err}
        log(f"host-local {name}: median {med * 1e3:.1f} ms ({', '.join(f'{t * 1e3:.1f}' for t in secs)}), "
            f"bus bandwidth {factor:.3f} N/t = {factor * nb / med / 1e9:.2f} GB/s; "
            f"bitwise across ranks and vs the CPU [{card}]")
        del outs, results, cpu
    # the card's busy share over one ring allreduce, from a profiler trace
    trace_dir = os.path.join("chiprun_out", "host_local_trace")
    torch.cuda.synchronize()
    with profiling.trace(trace_dir):
        t0 = time.perf_counter()
        mpi_tpu_torch.run(lambda c, xs: c.allreduce(xs[c.rank], algorithm="ring"), xs,
                          backend="local", nranks=n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(trace_dir, profiling.TRACE_FILE)
    summary = profiling.trace_summary(path)
    os.remove(path)  # tens of MB of events; the summary is what is kept
    info["profile_ring"] = {"wall_ms": wall_ms, "device_busy_ms": summary["busy_ms"],
                            "busy_share": summary["busy_ms"] / wall_ms,
                            "kernel_launches": summary["kernel_launches"],
                            "copies_and_fills": summary["copies_and_fills"],
                            "top": summary["by_name"][:6]}
    log(f"host-local ring allreduce traced: wall {wall_ms:.1f} ms, card busy "
        f"{summary['busy_ms']:.1f} ms ({100 * summary['busy_ms'] / wall_ms:.1f}%), "
        f"{summary['kernel_launches']} kernel launches, "
        f"{summary['copies_and_fills']} copies and fills [{card}]")
    record["host_local"] = info
    del xs, xs_cpu, want
    torch.cuda.empty_cache()


def host_socket_phase(torch, record):
    """Phases 14 and 15: the launcher's socket ranks on the card, and the
    examples under the local backend and as socket ranks against SPMD."""
    import mpi_tpu_torch
    from mpi_tpu_torch.examples.jacobi import jacobi_program
    from mpi_tpu_torch.examples.pi import pi_program

    card = card_line()
    nr = 4
    out_dir = os.path.abspath(os.path.join("chiprun_out", "host_socket"))
    if os.path.isdir(out_dir):
        for f in os.listdir(out_dir):
            os.remove(os.path.join(out_dir, f))
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", str(nr), "--timeout", "400",
         os.path.join("mpi_tpu_torch", "examples", "host_allreduce.py"),
         "--out", out_dir, "--mib", str(NORTH_STAR_ELEMS * 4 >> 20), "--seed", str(HOST_SEED)],
        cwd=root, capture_output=True, text=True, timeout=450)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"host-socket ranks failed (rc {res.returncode}):\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
    ranks = []
    for r in range(nr):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if not all(d["device"].startswith("cuda") for d in ranks):
        raise RuntimeError(f"socket ranks not on the card: {[d['device'] for d in ranks]}")
    info = {"card": card, "ranks": nr, "launcher_wall_s": wall,
            "bytes_per_rank": ranks[0]["bytes_per_rank"]}
    nb = ranks[0]["bytes_per_rank"]
    for algo in ("ring", "rabenseifner"):
        d = ranks[0][algo]
        med = d["median_ms"] / 1e3
        info[f"allreduce {algo}"] = dict(
            d, busbw_GBps=2 * (nr - 1) / nr * nb / med / 1e9,
            pickled_bytes_all_ranks=[x[algo]["pickled_bytes"] for x in ranks])
        log(f"host-socket allreduce {algo}: median {d['median_ms']:.1f} ms "
            f"({', '.join(f'{t * 1e3:.1f}' for t in d['s'])}), bus bandwidth 2(P-1)/P N/t "
            f"= {info[f'allreduce {algo}']['busbw_GBps']:.2f} GB/s, pickled bytes "
            f"{info[f'allreduce {algo}']['pickled_bytes_all_ranks']}, float64 error "
            f"{d['max_abs_err_vs_f64']:.3g} [{card}]")
    small = ranks[0]["allreduce_1KiB_2ranks"]
    info["allreduce_1KiB_2ranks"] = small
    log(f"host-socket allreduce 1 KiB float32, 2 ranks: median {small['median_ms']:.3f} ms "
        f"({', '.join(f'{t * 1e3:.3f}' for t in small['s'])}) [{card}]")
    log(f"host-socket: launcher wall {wall:.1f} s for {nr} ranks")
    record["host_socket"] = info

    # 15. the examples, unmodified, against their SPMD results on the card
    pi_spmd = mpi_tpu_torch.run(pi_program, nranks=nr)
    pi_local = mpi_tpu_torch.run(pi_program, backend="local", nranks=nr)
    blocks, resid = mpi_tpu_torch.run(jacobi_program, nranks=nr)
    jac_local = mpi_tpu_torch.run(jacobi_program, backend="local", nranks=nr)
    for r in range(nr):
        if not (torch.equal(pi_local[r], pi_spmd[r]) and float(pi_spmd[r]) == ranks[r]["pi"]):
            raise RuntimeError(f"pi rank {r}: local {float(pi_local[r])}, socket "
                               f"{ranks[r]['pi']}, SPMD {float(pi_spmd[r])}")
        sock_block = torch.tensor(ranks[r]["jacobi"]["block"], dtype=torch.float32)
        if not (torch.equal(jac_local[r][0], blocks[r]) and torch.equal(jac_local[r][1], resid[r])
                and torch.equal(sock_block, blocks[r].cpu())
                and ranks[r]["jacobi"]["residual"] == float(resid[r])):
            raise RuntimeError(f"jacobi rank {r}: local or socket differs from SPMD")
    record["host_examples"] = {"pi": float(pi_spmd[0]), "jacobi_residual": float(resid[0]),
                               "ranks": nr}
    log(f"examples pi ({float(pi_spmd[0]):.6f}) and jacobi (residual {float(resid[0]):.3e}): "
        f"local backend and socket ranks on the card bitwise equal to SPMD")


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
    # each main path's launches, read right after the path ran
    paths = {"north-star data-parallel step": ring_launches(ring)}

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
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for gname, groups in RING_GROUPINGS.items():
            g = P if groups is None else len(groups[0])
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

    # 5-7. the multi-parallel dry run, the full-width step, the examples -------
    dryrun_phase(torch, paths, record)
    lap("dry run")
    steps, step_args = step_phase(torch, dev, paths, record)
    lap("full-width step")
    checkpoint_phase(torch, dev, steps, step_args, record)
    lap("checkpoint")
    aot_phase(torch, dev, steps, step_args, paths, record)
    lap("AOT")
    del steps, step_args
    torch.cuda.empty_cache()
    gradient_phase(torch, record)
    lap("gradient")
    examples_phase(torch, record)
    lap("examples")

    # 8. timing at the north-star sizes -------------------------------------------
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
            "replaces": REPLACES,
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

    # 9-12. ring attention -----------------------------------------------------
    kernels += attention_phases(torch, dev, gen, record, paths)
    torch.cuda.empty_cache()

    # 13-15. the host layer -------------------------------------------------------
    host_local_phase(torch, record)
    lap("host-local")
    host_socket_phase(torch, record)
    lap("host-socket and examples")
    for k in kernels:  # launches: every main path's, summed
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()
                                 if c.get(k["name"])}
        k["launches"] = sum(k["launches_by_path"].values())
    record["launches_by_path"] = paths
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
