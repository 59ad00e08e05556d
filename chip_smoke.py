#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero without the final
ok line:

1. the card's name and power limit (nvidia-smi) and the kernel build
   (``nvcc`` of every ``mpi_tpu_torch/csrc`` source, in parallel, timed);
2. Jacobi through ``mpi_tpu_torch.run(jacobi_program, nranks=8)`` on the
   card, against the same program on the CPU;
3. the main path: a data-parallel step through ``run(..., nranks=8)`` with a
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
5. timing with CUDA events (median of 10 runs after 2 warm-up runs) of the
   kernel, the plain version and one PyTorch library call computing the
   same function, at the north-star sizes, beside the least time the card
   could take (bytes moved over the 3.35 TB/s datasheet rate), and the
   measured device-to-device copy rate;
6. one ``{"kernels": [...]}`` JSON line, then the ok line.

The full record also goes to ``chiprun_out/chip_smoke.json``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM datasheet
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
P = 8
NORTH_STAR_ELEMS = (256 << 20) // 4     # 256 MiB of float32 per rank
REPLACES = "mpi_tpu/tpu/pallas_ring.py:434"
SOURCE = "mpi_tpu_torch/csrc/ring.cu"


def log(msg):
    print(msg, flush=True)


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

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    record["build_s"] = {k: round(v, 2) for k, v in built.items()}
    log(f"build: {record['build_s']} (wall {time.perf_counter() - t0:.2f} s)")
    for name, report in _build.PTXAS_REPORT.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

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
        k_ms = time_ms(torch, m["kernel"])
        p_ms = time_ms(torch, m["plain"])
        l_ms = time_ms(torch, m["library"])
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
        }
        kernels.append(entry)
        log(f"{mode}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library "
            f"{l_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({entry['pct_of_bound']:.1f}% of bound, {entry['GBps']:.1f} GB/s)")
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
