"""The reference's host-layer test files, run unchanged on the port.

ROADMAP Queue 3 item 3: fourteen reference test files of host modules the
port has (``tests/test_local_backend.py`` … ``test_sanitize_native.py``)
were cited by no port test.  Each ``tests/test_torch_host_ref_<name>.py``
loads the reference file ``tests/test_<name>.py``, rewrites its imports
of ``mpi_tpu`` to ``mpi_tpu_torch`` (imports of ``mpi_tpu.tpu``, the SPMD
backend, stay the reference's), and collects its test functions, fixtures
and parametrizations as they are: the same numpy-seeded inputs, the same
oracles, the same assertions and tolerances, now against the port.  The
reference's own file runs every case on the reference in the same suite,
so each collected case holds one program through both packages.

A rewritten module gets the port's world runners with ``device="cpu"``
(``run_local``, ``run``, ``init``, ``verify_run``, the reference tests'
in-process socket and shm worlds, and the transports they construct); no
card is used and nothing falls back to the CPU behind a caller's back.
Processes the port starts for a test (serve workers and their
replacements) take ``MPI_TPU_DEVICE=cpu`` from the environment, which the
``cpu_device_env`` fixture below sets for the test's duration only.
Its ``mpit`` is the port's, with the reference's internal ``counters``
object read through the port's pvars (``mpit._PVAR_OF``).

Each file lists the cases it does not collect in ``EXCLUDED``, every one
with its reason: an SPMD case (the port's SPMD tests hold those), a case
that reads the reference's internals or its unported modules (mapped to
the port test that holds the same behavior), or a launcher case (the
port's launcher tests).  ``test_every_case_is_held_or_excluded`` below
checks that each reference test function is collected or excluded with a
reason, so a test added to a reference file must be accounted for.
"""

from __future__ import annotations

import importlib
import pathlib
import re
import sys
import types
from typing import Dict, Optional, Sequence

import pytest

import mpi_tpu_torch
from mpi_tpu_torch.transport import local as _local
from mpi_tpu_torch.transport import shm as _shm
from mpi_tpu_torch.transport import socket as _socket

TESTS = pathlib.Path(__file__).resolve().parent
SHIM = "_mtt_ref_port"


@pytest.fixture
def cpu_device_env(monkeypatch):
    """``MPI_TPU_DEVICE=cpu`` while one test runs: the device of every
    process the port starts for it (serve workers, their replacements).
    Scoped to the test, since ``tests/test_torch_host_ft.py`` and others
    check that nothing runs on the CPU without being told."""
    from mpi_tpu_torch.membership import ENV_DEVICE

    monkeypatch.setenv(ENV_DEVICE, "cpu")


def _run_local(fn, nranks, *args, **kwargs):
    kwargs.setdefault("device", "cpu")
    return _local.run_local(fn, nranks, *args, **kwargs)


def _run(fn, *args, **kwargs):
    kwargs.setdefault("device", "cpu")
    return mpi_tpu_torch.run(fn, *args, **kwargs)


def _init(backend=None, device="cpu"):
    return mpi_tpu_torch.init(backend, device=device)


def _comm_self(device="cpu"):
    return mpi_tpu_torch.comm_self(device=device)


def _verify_run(fn, nranks, *args, **kwargs):
    from mpi_tpu_torch.trace import verify_run

    kwargs.setdefault("device", "cpu")
    return verify_run(fn, nranks, *args, **kwargs)


def _run_shm_world(fn, nranks, timeout=60.0):
    return _shm.run_shm(fn, nranks, timeout=timeout, device="cpu")


def _run_socket_world(fn, nranks, timeout=60.0):
    from tests.test_torch_host_socket import port_socket_world

    return port_socket_world(fn, nranks, timeout=timeout)


class SocketTransport(_socket.SocketTransport):
    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


class ShmTransport(_shm.ShmTransport):
    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


class _Counters:
    """The reference's internal counter object (``mpi_tpu.mpit.counters``)
    read through the port's pvars: ``counters.<name>`` is the pvar the
    port's ``mpit._PVAR_OF`` maps the reference's count name to, or for
    the receive pool's short attribute names (``mpi_tpu/mpit.py:219-225``)
    the pvar of ``_RP``."""

    _RP = {"rp_hits": "recv_pool_hits", "rp_misses": "recv_pool_misses",
           "rp_rdv": "recv_pool_rendezvous", "rp_steered": "recv_bytes_steered",
           "rp_fold": "recv_pool_fold_fallbacks",
           "rp_user_in": "recv_user_inplace",
           "rp_user_fb": "recv_user_fallbacks"}

    def __getattr__(self, name):
        from mpi_tpu_torch import mpit

        return mpit.pvar_read(self._RP.get(name) or mpit._PVAR_OF[name])


def _mpit() -> types.ModuleType:
    """The port's ``mpit`` plus the reference's ``counters`` view."""
    from mpi_tpu_torch import mpit

    mod = types.ModuleType("mpi_tpu_torch.mpit")
    mod.__dict__.update(vars(mpit))
    mod.counters = _Counters()
    return mod


def _shim() -> types.ModuleType:
    """The module the rewritten imports of runners and transports read:
    the port's, on the CPU; anything else is the port package's."""
    mod = sys.modules.get(SHIM)
    if mod is None:
        mod = types.ModuleType(SHIM)
        mod.run_local = _run_local
        mod.run = _run
        mod.init = _init
        mod.comm_self = _comm_self
        mod.verify_run = _verify_run
        mod.run_shm_world = _run_shm_world
        mod.run_socket_world = _run_socket_world
        mod.SocketTransport = SocketTransport
        mod.ShmTransport = ShmTransport
        mod.unported = _unported
        mod.mpit = _mpit()
        mod.__getattr__ = lambda name: getattr(mpi_tpu_torch, name)
        sys.modules[SHIM] = mod
    return mod


# names whose rewritten import reads the shim rather than the port module
_SHIMMED = {"run_local", "verify_run", "run_shm_world", "run_socket_world",
            "SocketTransport", "ShmTransport", "mpit"}
_FROM = re.compile(
    r"^(?P<ind>[ \t]*)from (?P<mod>mpi_tpu(?:\.[\w.]+)?|(?:tests\.)?test_\w+) "
    r"import (?P<names>\([^)]*\)|[^\n]+)$", re.M)


def _rewrite_from(m: re.Match) -> str:
    ind, mod, names = m.group("ind"), m.group("mod"), m.group("names")
    if mod == "mpi_tpu.tpu" or mod.startswith("mpi_tpu.tpu."):
        return m.group(0)  # the SPMD backend stays the reference's
    names = re.sub(r"#[^\n]*", "", names)  # comments, one per line
    items = [n.strip() for n in names.strip().strip("()").replace("\n", " ")
             .split(",") if n.strip()]
    shimmed = [n for n in items if n.split(" as ")[0].strip() in _SHIMMED]
    rest = [n for n in items if n not in shimmed]
    lines = []
    if shimmed:
        lines.append(f"{ind}from {SHIM} import {', '.join(shimmed)}")
    if rest:
        if mod.startswith(("tests.", "test_")):
            lines.append(f"{ind}from {mod} import {', '.join(rest)}")
        else:
            port = "mpi_tpu_torch" + mod[len("mpi_tpu"):]
            have = [n for n in rest if _exists(port, n.split(" as ")[0].strip())]
            if have:
                lines.append(f"{ind}from {port} import {', '.join(have)}")
            for n in rest:
                if n not in have:  # a name of an unported module or item
                    src, _, alias = n.partition(" as ")
                    lines.append(f"{ind}{(alias or src).strip()} = "
                                 f"{SHIM}.unported({port + '.' + src.strip()!r})")
    return "\n".join(lines) if lines else f"{ind}pass"


def _exists(module: str, name: str) -> bool:
    try:
        mod = importlib.import_module(module)
    except ImportError:
        return False
    if hasattr(mod, name):
        return True
    try:
        importlib.import_module(f"{module}.{name}")
        return True
    except ImportError:
        return False


def _unported(what: str):
    """A stand-in for a name the port does not have: using it raises."""
    def missing(*args, **kwargs):
        raise NotImplementedError(f"{what} is not in the port")

    return missing


def rewrite(src: str) -> str:
    """The reference test source with its host imports on the port."""
    src = _FROM.sub(_rewrite_from, src)
    src = re.sub(r"^([ \t]*)import mpi_tpu[ \t]*$", rf"\1import {SHIM} as mpi_tpu",
                 src, flags=re.M)
    return src


def load(name: str) -> types.ModuleType:
    """The reference file ``tests/<name>.py`` rewritten onto the port."""
    _shim()
    path = TESTS / f"{name}.py"
    mod = types.ModuleType(f"tests._port_{name}")
    mod.__file__ = str(path)
    setattr(mod, SHIM, _shim())  # read by the stand-ins of unported names
    exec(compile(rewrite(path.read_text()), f"<port of tests/{name}.py>",
                 "exec"), mod.__dict__)
    return mod


def _reference_tests(mod: types.ModuleType):
    return [k for k, v in vars(mod).items()
            if k.startswith("test_") and callable(v)]


def port_cases(name: str, excluded: Optional[Dict[str, str]] = None,
               only: Optional[Sequence[str]] = None) -> dict:
    """The test functions and fixtures of ``tests/<name>.py`` on the port,
    less ``excluded`` (or just those named in ``only``); for a test
    module's ``globals().update``."""
    mod = load(name)
    excluded = excluded or {}
    unknown = (set(excluded) | set(only or ())) - set(_reference_tests(mod))
    if unknown:
        raise ValueError(f"{name}: cases that do not exist: {unknown}")
    out = {}
    for k, v in vars(mod).items():
        if k.startswith("test_") and callable(v):
            if k not in excluded and (only is None or k in only):
                out[k] = v
        elif hasattr(v, "_pytestfixturefunction") or type(v).__name__ in (
                "FixtureFunctionDefinition", "FixtureFunctionMarker"):
            out[k] = v
    return out


REFERENCE_FILES = (
    "local_backend", "socket_backend", "groups", "attributes", "errors",
    "mpit", "nonblocking", "ops_extended", "scan_reduce_scatter",
    "vector_collectives", "segmented_collectives2", "resilience", "codec",
    "sanitize_native", "zero_copy_user", "spawn", "io", "serve",
    "federation_store", "federation", "schedules")


@pytest.mark.parametrize("name", REFERENCE_FILES)
def test_every_case_is_held_or_excluded(name):
    port = importlib.import_module(f"tests.test_torch_host_ref_{name}")
    ref = importlib.import_module(f"tests.test_{name}")
    names = _reference_tests(ref)
    for k in names:
        held = k in vars(port)
        why = port.EXCLUDED.get(k, "")
        assert held != bool(why), (name, k, "held" if held else "unaccounted")
    assert set(port.EXCLUDED) <= set(names)


def test_rewrite_keeps_the_spmd_backend_and_moves_the_host_layer():
    src = ("import mpi_tpu\nfrom mpi_tpu import ops, Status\n"
           "from mpi_tpu.tpu import run_spmd\n"
           "    from mpi_tpu.transport.local import run_local\n"
           "from mpi_tpu.trace import verify_run, TracingTransport\n")
    assert rewrite(src) == (
        f"import {SHIM} as mpi_tpu\nfrom mpi_tpu_torch import ops, Status\n"
        "from mpi_tpu.tpu import run_spmd\n"
        f"    from {SHIM} import run_local\n"
        f"from {SHIM} import verify_run\n"
        "from mpi_tpu_torch.trace import TracingTransport\n")
