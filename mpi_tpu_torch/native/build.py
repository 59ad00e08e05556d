"""Build-on-first-use of the port's native shm ring — its own copy of
``mpi_tpu/native/build.py`` (``ensure_built`` :60, ``load_shmring`` :110,
the sanitizer modes :30).

``g++`` compiles ``native/shmring.cpp`` (host C++, not a kernel) into
``mpi_tpu_torch/_build/shmring-<hash>[.<mode>].so``, where the hash is
that of the source and the flags, so an edited source never loads a stale
library.  Many rank processes may start at once (the launcher spawns them
in a burst): the compile is serialized by an exclusive ``flock`` and
lands by atomic rename; the losers of the race find the finished
library.  A failed build raises :class:`NativeBuildError` with the
compiler's output — the shm backend never falls back to another
transport.

Sanitizer builds: ``MPI_TPU_SANITIZE=address|undefined|thread`` adds the
matching ``-fsanitize=`` flags and caches under a mode-specific name.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "shmring.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

# sanitizer mode -> (cache-name infix, -fsanitize= flag list)
_SANITIZERS = {
    "address": ("asan", ["-fsanitize=address", "-fno-omit-frame-pointer",
                         "-g"]),
    "undefined": ("ubsan", ["-fsanitize=undefined",
                            "-fno-sanitize-recover=undefined", "-g"]),
    "thread": ("tsan", ["-fsanitize=thread", "-g"]),
}

_lib = None


class NativeBuildError(RuntimeError):
    pass


def sanitize_mode() -> str:
    """The ``MPI_TPU_SANITIZE`` knob, validated ('' = plain build)."""
    mode = os.environ.get("MPI_TPU_SANITIZE", "").strip()
    if mode and mode not in _SANITIZERS:
        raise NativeBuildError(
            f"unknown MPI_TPU_SANITIZE={mode!r}; accepted: "
            f"{sorted(_SANITIZERS)} (or unset for a plain build)")
    return mode


def _flags(mode: str) -> list:
    return CXX_FLAGS + (_SANITIZERS[mode][1] if mode else [])


def so_path(mode: str = "") -> Path:
    """Where the library of ``mode`` lands (keyed by source and flags)."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(_flags(mode)).encode())
    infix = f".{_SANITIZERS[mode][0]}" if mode else ""
    return BUILD_DIR / f"shmring-{h.hexdigest()[:16]}{infix}.so"


def ensure_built(force: bool = False) -> str:
    """Compile ``shmring.cpp`` if needed; return the library's path.
    ``force`` rebuilds even when the cached library exists (the recovery
    path for a library that fails to load)."""
    mode = sanitize_mode()
    so = so_path(mode)
    if not force and so.exists():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".shmring.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not force and so.exists():
                return str(so)  # another process built it while we waited
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            # -lrt: shm_open/shm_unlink live in librt on older glibc
            cmd = ["g++", *_flags(mode), "-o", tmp, str(SRC), "-pthread",
                   "-lrt"]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                os.unlink(tmp)
                raise NativeBuildError(
                    "g++ not found; the shm backend needs the native "
                    "toolchain") from e
            if proc.returncode != 0:
                os.unlink(tmp)
                raise NativeBuildError(
                    f"shmring.cpp failed to compile"
                    f"{f' (MPI_TPU_SANITIZE={mode})' if mode else ''}:\n"
                    f"{proc.stderr[-2000:]}")
            os.replace(tmp, so)
            return str(so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_shmring() -> ctypes.CDLL:
    """Load (building if necessary) and type the native library."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(ensure_built())
    except OSError:
        lib = ctypes.CDLL(ensure_built(force=True))
    vp, u64, u32, dbl = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
                         ctypes.c_double)
    sig = {
        "shmring_create": (vp, [ctypes.c_char_p, u64]),
        "shmring_open": (vp, [ctypes.c_char_p, dbl]),
        "shmring_avail": (u64, [vp]),
        # buffers are c_void_p: bytes, ctypes buffers and raw addresses
        "shmring_write": (ctypes.c_int, [vp, vp, u64, dbl]),
        "shmring_read": (ctypes.c_int, [vp, vp, u64, dbl]),
        "shmring_read_some": (ctypes.c_int64, [vp, vp, u64, dbl]),
        "shmring_write_some": (ctypes.c_int64, [vp, vp, u64, dbl]),
        "shmring_close": (None, [vp]),
        "shmring_unlink": (ctypes.c_int, [ctypes.c_char_p]),
        "shmdb_create": (vp, [ctypes.c_char_p]),
        "shmdb_open": (vp, [ctypes.c_char_p, dbl]),
        "shmdb_read": (u32, [vp]),
        "shmdb_ring": (None, [vp]),
        "shmdb_wait": (u32, [vp, u32, dbl]),
        "shmdb_close": (None, [vp]),
        "shmdb_unlink": (ctypes.c_int, [ctypes.c_char_p]),
        # the collective arena (coll_sm.py): one segment per shm
        # communicator, per-rank flag lines driven by shmflag_*
        "shmarena_create": (vp, [ctypes.c_char_p, u64]),
        "shmarena_open": (vp, [ctypes.c_char_p, dbl]),
        "shmarena_addr": (u64, [vp]),
        "shmarena_size": (u64, [vp]),
        "shmarena_close": (None, [vp]),
        "shmarena_unlink": (ctypes.c_int, [ctypes.c_char_p]),
        "shmflag_read": (u32, [u64]),
        "shmflag_post": (None, [u64, u32]),
        "shmflag_wait_ge": (u32, [u64, u32, dbl]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _lib = lib
    return lib
