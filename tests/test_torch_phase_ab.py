"""``mpi_tpu_torch/tools/phase_ab.py``, the tool that times
``chip_smoke.py``'s attention phases and phase 13 of a tree: without a
card it refuses with exit code 2 and writes no record (the timing itself
runs on the card, where ``PERF.md`` cites its records)."""

import importlib.util
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_phase_ab_refuses_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "mpi_tpu_torch.tools.phase_ab",
                          "--tree", str(ROOT), "--tag", "t", "--out", str(tmp_path / "out")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2, res.stderr
    assert "no CUDA device" in res.stderr
    assert not list((tmp_path / "out").glob("phase_ab_*.json"))


def test_sass_compare_names_instances_apart_from_their_file_hash():
    """``tools/sass_compare.py`` reads ``cuobjdump -sass`` text: the same
    instance from two builds of an edited source (its anonymous namespace
    named by a hash of the file) is one name, addresses are dropped, and a
    changed instruction shows."""
    from mpi_tpu_torch.tools import sass_compare

    def dump(file_hash, op):
        space = f"_GLOBAL__N__{file_hash}_16_attention_bwd_cu_{file_hash}"
        return (f"\t\tFunction : _ZN{len(space)}{space}18attn_bwd_dq_kernelIfLi128EEEvPKT_\n"
                "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
                "                  /* 0x00000a00ff017b82 */\n"
                f"        /*0010*/                   {op} ;"
                "                                   /* 0x000fe20000000f00 */\n")

    a, b, c = (sass_compare.parse(dump(h, op)) for h, op in
               (("c5f705b1", "EXIT"), ("9a0b7c3d", "EXIT"), ("9a0b7c3d", "BRA 0x10")))
    assert list(a) == list(b) == ["_ZN<anonymous>18attn_bwd_dq_kernelIfLi128EEEvPKT_"]
    assert a == b and a != c
    assert next(iter(a.values())) == ["LDC R1, c[0x0][0x28]", "EXIT"]
    assert sass_compare.main([]) == 2


def test_sass_compare_leaves_instances_meant_to_change_out_of_its_verdict(monkeypatch, capsys):
    """``--changed REGEX`` names the instances an edit rewrote (the float32
    backward above d = 256 and a new probe): they are listed apart, and
    the verdict is on the others alone; without it the same pair fails."""
    from mpi_tpu_torch.tools import sass_compare

    def dump(file_hash, body):
        out = []
        for name, op in body:
            space = f"_GLOBAL__N__{file_hash}_21_attention_bwd_wide_cu_{file_hash}"
            out.append(f"\t\tFunction : _ZN{len(space)}{space}{len(name)}{name}E\n"
                       f"        /*0000*/                   {op} ;"
                       "                                   /* 0x000fe20000000f00 */\n")
        return "".join(out)

    dumps = {"old.so": dump("c5f705b1", [("attn_bwd_dq_wide_bf16", "EXIT"),
                                         ("attn_bwd_dq_wide_f32", "BRA 0x10")]),
             "new.so": dump("9a0b7c3d", [("attn_bwd_dq_wide_bf16", "EXIT"),
                                         ("attn_bwd_dq_wide_f32", "EXIT"),
                                         ("wgmma_tf32_probe_kernel", "EXIT")])}

    class Done:
        def __init__(self, path):
            self.stdout = dumps[path]

    monkeypatch.setattr(sass_compare.subprocess, "run", lambda cmd, **kw: Done(cmd[-1]))
    r = sass_compare.compare("old.so", "new.so", r"_f32E|probe")
    assert (r["old"], r["new"], r["identical"]) == (1, 1, 1)
    assert [n.split(">")[-1] for n in r["changed"]] == ["20attn_bwd_dq_wide_f32E",
                                                         "23wgmma_tf32_probe_kernelE"]
    assert sass_compare.main(["--changed", r"_f32E|probe", "old.so", "new.so"]) == 0
    assert "2 meant to change" in capsys.readouterr().out
    assert sass_compare.main(["old.so", "new.so"]) == 1


def test_wide_ab_refuses_without_a_card(tmp_path):
    """``mpi_tpu_torch/tools/wide_ab.py``, which holds builds of the forward
    above d = 256 against a parent tree's on the card (bitwise in bf16,
    timed at the wide serving shape), refuses without a card with exit
    code 2 and writes no record."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "wide_ab.json"
    res = subprocess.run([sys.executable, "-m", "mpi_tpu_torch.tools.wide_ab",
                          "--parent", str(ROOT), "--out", str(out)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2, res.stderr
    assert "no CUDA device" in res.stderr
    assert not out.exists()


def test_wide_ab_narrow_backward_refuses_without_a_card(tmp_path):
    """``wide_ab --source attention_bwd`` (the bf16 backward at d = 128 and
    256 against a parent tree's, within the allowance, timed at the serving
    shape) refuses without a card as the forward's comparison does; it
    compares phase 11's 96 bf16 cases at those head dims."""
    import chip_smoke

    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "wide_ab.json"
    res = subprocess.run([sys.executable, "-m", "mpi_tpu_torch.tools.wide_ab",
                          "--parent", str(ROOT), "--source", "attention_bwd", "--out", str(out)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2, res.stderr
    assert "no CUDA device" in res.stderr
    assert not out.exists()
    assert sum(case[0] <= 256 for case in chip_smoke.parity_grid(False)) == 96


def test_wide_ab_narrow_float32_backward_refuses_without_a_card(tmp_path):
    """``wide_ab --source attention_bwd --dtype float32`` (the float32
    backward at d = 128 and 256 against a parent tree's: within the
    allowance, bitwise the parent's or not, two launches bitwise equal,
    timed at the serving shape and at d = 256 beside SDPA's float32
    backward) refuses without a card as the bf16 comparison does; it
    compares phase 11's 120 float32 cases at those head dims."""
    import chip_smoke

    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "wide_ab.json"
    res = subprocess.run([sys.executable, "-m", "mpi_tpu_torch.tools.wide_ab",
                          "--parent", str(ROOT), "--source", "attention_bwd", "--dtype",
                          "float32", "--out", str(out)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2, res.stderr
    assert "no CUDA device" in res.stderr
    assert not out.exists()
    assert sum(case[0] <= 256 for case in chip_smoke.parity_grid(True)) == 120


def test_wide_ab_narrow_forward_refuses_without_a_card(tmp_path):
    """``wide_ab --source attention`` (the bf16 forward at d = 128 and 256
    against a parent tree's, bit for bit and within the allowance, timed at
    the serving shape and at d = 256) refuses without a card as the other
    comparisons do."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "wide_ab.json"
    res = subprocess.run([sys.executable, "-m", "mpi_tpu_torch.tools.wide_ab",
                          "--parent", str(ROOT), "--source", "attention", "--out", str(out)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2, res.stderr
    assert "no CUDA device" in res.stderr
    assert not out.exists()


def test_wide_ab_narrow_float32_forward_refuses_without_a_card(tmp_path):
    """``wide_ab --source attention --dtype float32`` (both trees' float32
    forward at d = 128 and 256 against the plain version, bitwise counts,
    two launches equal, timed at the serving shape and at d = 256 beside
    SDPA's float32 forward) refuses without a card as the bf16 comparison
    does; it holds phase 11's 120 float32 cases at those head dims."""
    import chip_smoke

    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "wide_ab.json"
    res = subprocess.run([sys.executable, "-m", "mpi_tpu_torch.tools.wide_ab",
                          "--parent", str(ROOT), "--source", "attention", "--dtype",
                          "float32", "--out", str(out)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2, res.stderr
    assert "no CUDA device" in res.stderr
    assert not out.exists()
    assert sum(case[0] <= 256 for case in chip_smoke.parity_grid(True)) == 120


def test_ptxas_table_names_every_attention_instance():
    """``chip_smoke.ptxas_table`` names each instance from ``nvcc -Xptxas
    -v`` output (phase 12 prints the bf16 forward's and backward's, and
    the float32 backward's at d = 128, registers and spills by these
    names; the float32 backward at d = 256 is an instance of the same
    kernels)."""
    import chip_smoke

    space = "_GLOBAL__N__c5f705b1_12_attention_cu_c5f705b1"
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN{len(space)}{space}{name}' for 'sm_90a'\n"
        f"ptxas info    : Used {regs} registers, used 0 barriers, 16 bytes cumulative stack size\n"
        f"    {spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads"
        for name, regs, spill in (
            ("20attn_fwd_bf16_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16PfNS_3GeoE", 168, 0),
            ("15attn_fwd_kernelIfLi256EEEvPKT_S3_S3_PS1_PfNS_3GeoE", 255, 8),
            ("23attn_bwd_dq_bf16_kernelILi256EEEv14CUtensorMap_st", 168, 0),
            ("23attn_bwd_dkv_f32_kernelILi128EEEv14CUtensorMap_stS0_S0_S0_S0_S0_PfS1_NS_3GeoE",
             168, 0),
            ("22attn_bwd_dq_f32_kernelILi256EEEv14CUtensorMap_stS0_S0_S0_PKfS2_PfNS_3GeoE", 168, 0),
            ("23attn_bwd_dkv_f32_kernelILi256EEEv14CUtensorMap_stS0_S0_S0_S0_S0_PfS1_NS_3GeoE",
             168, 0)))
    rows = chip_smoke.ptxas_table({"attention": log})
    assert [(r["kernel"], r["registers"], r["spill_stores"]) for r in rows] == [
        ("attn_fwd_bf16_kernel<bf16, 128>", 168, 0), ("attn_fwd_kernel<float32, 256>", 255, 8),
        ("attn_bwd_dq_bf16_kernel<bf16, 256>", 168, 0),
        ("attn_bwd_dkv_f32_kernel<float32, 128>", 168, 0),
        ("attn_bwd_dq_f32_kernel<float32, 256>", 168, 0),
        ("attn_bwd_dkv_f32_kernel<float32, 256>", 168, 0)]


def test_phase11_grid_is_the_one_wide_ab_compares():
    """``chip_smoke.parity_grid`` is phase 11's grid, read by
    ``tools/wide_ab.py`` too: float32 184 cases, bf16 160, 64 of each above
    d = 256, d = 640 and 1152 last (the cases held before them draw the
    inputs they drew then) at Sb = 112 alone; 48 bf16 cases at the head
    dims of the bitwise check."""
    import chip_smoke
    from mpi_tpu_torch.tools import wide_ab

    f32, bf16 = list(chip_smoke.parity_grid(True)), list(chip_smoke.parity_grid(False))
    assert (len(f32), len(bf16)) == (184, 160)
    for grid in (f32, bf16):
        dims = list(dict.fromkeys(case[0] for case in grid))
        assert dims == [128, 256, 384, 512, 1024, 640, 1152]
        assert sum(case[0] > 256 for case in grid) == 64
        assert {case[1] for case in grid if case[0] in (640, 1152)} == {112}
    assert sum(case[0] in wide_ab.BITWISE_DIMS for case in bf16) == 48


def test_wide_ab_holds_a_timed_shape_to_the_normwise_allowance():
    """``wide_ab.hold_timed`` measures a tree's (dq, dk, dv) at a timed
    shape against the plain backward's as phase 12 holds the serving
    shape: normwise (1e-4 of the largest |plain| of each gradient), with
    the elementwise share beside it; a gradient off by more than its
    allowance shows a share above 1 in either measure."""
    import chip_smoke
    import numpy as np
    import torch

    from mpi_tpu_torch.tools import wide_ab

    rng = np.random.RandomState(0)
    want = tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for shape in ((2, 4, 16, 8), (2, 1, 16, 8), (2, 1, 16, 8)))
    assert wide_ab.hold_timed(torch, chip_smoke, want, want, torch.float32) == (0.0, 0.0)
    # every element moved by half the normwise allowance of its gradient:
    # within it, and past the elementwise allowance of the smallest entries
    near = tuple(w + 0.5e-4 * float(w.abs().max()) for w in want)
    normwise, elementwise = wide_ab.hold_timed(torch, chip_smoke, near, want, torch.float32)
    assert 0.49 < normwise <= 0.5 + 1e-3 and elementwise > 1.0
    # one element of dv off by twice its normwise allowance
    far = (want[0], want[1], want[2].clone())
    far[2][1, 0, 3, 5] += 2e-4 * float(want[2].abs().max())
    normwise, _ = wide_ab.hold_timed(torch, chip_smoke, far, want, torch.float32)
    assert 1.99 < normwise < 2.01


def test_chip_smoke_keeps_bytecode_only_where_none_is_written(tmp_path, monkeypatch):
    """``chip_smoke.cache_bytecode``: where bytecode is written, or the
    module ships its own, it changes nothing; where neither, the script
    and every process it starts keep what they compile under one
    temporary directory (``PYTHONPYCACHEPREFIX``, writing on), so a second
    process reads what the first compiled."""
    import chip_smoke

    pkg = tmp_path / "src" / "fresh_mod"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("VALUE = 7\n")
    monkeypatch.syspath_prepend(str(tmp_path / "src"))
    monkeypatch.setattr(sys, "pycache_prefix", None)
    monkeypatch.setattr(chip_smoke.tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("PYTHONPYCACHEPREFIX", raising=False)

    monkeypatch.setattr(sys, "dont_write_bytecode", False)
    assert chip_smoke.cache_bytecode("fresh_mod") is None
    assert chip_smoke.cache_bytecode("no_such_module_here") is None

    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    monkeypatch.setenv("PYTHONDONTWRITEBYTECODE", "1")
    shipped = pkg / "__pycache__"
    shipped.mkdir()
    (shipped / f"__init__.{sys.implementation.cache_tag}.pyc").write_bytes(b"")
    assert chip_smoke.cache_bytecode("fresh_mod") is None
    assert sys.dont_write_bytecode and sys.pycache_prefix is None

    (shipped / f"__init__.{sys.implementation.cache_tag}.pyc").unlink()
    prefix = chip_smoke.cache_bytecode("fresh_mod")
    assert prefix and os.path.dirname(prefix) == str(tmp_path)
    assert sys.pycache_prefix == prefix and not sys.dont_write_bytecode
    assert os.environ["PYTHONPYCACHEPREFIX"] == prefix
    assert "PYTHONDONTWRITEBYTECODE" not in os.environ
    res = subprocess.run([sys.executable, "-c", "import fresh_mod; print(fresh_mod.VALUE)"],
                         cwd=tmp_path / "src", capture_output=True, text=True, timeout=60)
    assert res.returncode == 0 and res.stdout.strip() == "7", res.stderr
    kept = importlib.util.cache_from_source(str(pkg / "__init__.py"))
    assert kept.startswith(prefix + os.sep) and os.path.isfile(kept)
    assert not list(shipped.iterdir())
