"""``mpi_tpu_torch/tools/phase_ab.py``, the tool that times
``chip_smoke.py``'s attention phases and phase 13 of a tree: without a
card it refuses with exit code 2 and writes no record (the timing itself
runs on the card, where ``PERF.md`` cites its records)."""

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
