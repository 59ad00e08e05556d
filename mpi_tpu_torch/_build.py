"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``_build/<name>-<hash>.so``, where the hash is
that of the source, of every ``csrc/`` header it includes (directly or
through another header) and of the flags: an edited source or header never
loads a stale library.  ``build(names)`` starts one ``nvcc`` per source,
all at once, and waits for them together.  A failed build raises with the
compiler's output.

The first kernel call builds what it needs; ``chip_smoke.py`` calls
``build`` up front to time it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_ptr, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the attention entry points' tail: groups, ngroups, g, hq, hkv, sb, d,
# scale, causal, dtype, stream
_ATTN_TAIL = [_c_ptr] + [_c_int] * 6 + [ctypes.c_float, _c_int, _c_int, _c_ptr]
# C signatures of every entry point, by source
SIGNATURES: Dict[str, Dict[str, list]] = {
    "ring": {
        "ring_fold": [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_ll, _c_ll,
                      _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                      _c_ptr],
        "ring_gather": [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_ll, _c_int,
                        _c_int, _c_ptr],
        # the same with a [P] table of per-rank row pointers for x and the
        # span (first, count) of the ranks whose outputs are written
        "ring_fold_ptrs": [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_ll,
                           _c_ll, _c_ll] + [_c_int] * 8 + [_c_ptr],
        "ring_gather_ptrs": [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_ll]
                            + [_c_int] * 4 + [_c_ptr],
    },
    "peers": {
        "peers_handle_bytes": [],
        "peers_alloc": [_c_ptr, _c_ll],
        "peers_free": [_c_ptr],
        "peers_export": [_c_ptr, _c_ptr],
        "peers_open": [_c_ptr, _c_ptr],
        "peers_close": [_c_ptr],
        "peers_error": [_c_int, ctypes.c_char_p, _c_int],
    },
    "attention": {
        "attn_fwd": [_c_ptr] * 5 + _ATTN_TAIL,
    },
    "attention_bwd": {
        "attn_bwd_dq": [_c_ptr] * 7 + _ATTN_TAIL,
        "attn_bwd_dkv": [_c_ptr] * 8 + _ATTN_TAIL,
    },
    # the same entry points for head dims above 256
    "attention_wide": {
        "attn_fwd_wide": [_c_ptr] * 5 + _ATTN_TAIL,
    },
    "attention_bwd_wide": {
        "attn_bwd_dq_wide": [_c_ptr] * 7 + _ATTN_TAIL,
        "attn_bwd_dkv_wide": [_c_ptr] * 8 + _ATTN_TAIL,
        # b, out, stream: how TF32 wgmma reads a raw float32 word (a test's probe)
        "wgmma_tf32_probe": [_c_ptr] * 3,
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
PTXAS_REPORT: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from mpi_tpu_torch/csrc on first use")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly
    or through another header, each once."""
    seen, todo = [], [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.append(path)
        todo += [SRC_DIR / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile every named source that has no current library, all in
    parallel; returns the wall seconds of each build started."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took = {}
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        PTXAS_REPORT[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return took


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its argtypes set."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LIBS[name] = lib
    return lib
