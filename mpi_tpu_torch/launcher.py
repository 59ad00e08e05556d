"""mpirun-alike launcher — the port's own copy of ``mpi_tpu/launcher.py``
(``launch`` :29, ``_launch_once`` :82, ``main`` :188).

Spawns N rank processes of a user script, assigns ranks 0..N-1 through
the environment (``MPI_TPU_RANK`` / ``SIZE`` / ``RDV`` / ``BACKEND``, the
reference's names), hands them a file-based rendezvous directory for the
socket transport's port exchange, propagates the exit code of the first
failing rank and kills the remaining ranks.

Each rank binds card ``rank % device_count`` (on a one-card machine every
rank shares card 0: a CUDA card, unlike a TPU, can be shared between
processes).  ``--device cpu`` runs the ranks on the CPU instead — the
counterpart of the reference's CPU pin of its ranks' JAX.

Usage::

    python -m mpi_tpu_torch.launcher -n 4 prog.py [script args...]
    python -m mpi_tpu_torch.launcher -n 4 --device cpu prog.py
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional, Sequence

from . import membership
from .membership import ENV_BACKEND, ENV_DEVICE, ENV_RANK, ENV_RDV, ENV_SIZE

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(nranks: int, argv: Sequence[str], timeout: Optional[float] = None,
           backend: Optional[str] = None, restarts: int = 0,
           device: Optional[str] = None) -> int:
    """Run ``python argv...`` as ``nranks`` rank processes; return the exit
    code.  ``restarts``: after a nonzero exit or a hang (timeout), the
    WHOLE world is killed and relaunched up to this many times
    (``MPI_TPU_ATTEMPT`` carries the attempt number to the ranks).
    ``device`` (``"cpu"`` or a card) overrides every rank's default."""
    last = 0
    for attempt in range(restarts + 1):
        extra = {"MPI_TPU_ATTEMPT": str(attempt)}
        if device is not None:
            extra[ENV_DEVICE] = device
        try:
            last = _launch_once(nranks, argv, extra, timeout, backend)
        except TimeoutError:
            if attempt == restarts:
                raise
            continue
        if last == 0:
            return 0
    return last


def _launch_once(nranks: int, argv: Sequence[str],
                 env_extra: Optional[dict] = None,
                 timeout: Optional[float] = None,
                 backend: Optional[str] = None) -> int:
    if nranks < 1:
        raise ValueError(f"nranks must be >= 1, got {nranks}")
    backend = backend or os.environ.get(ENV_BACKEND, "socket")
    if backend != "socket":
        raise NotImplementedError(
            f"launcher backend {backend!r} is not ported yet (the shm "
            f"transport is ROADMAP.md item 16.4); use 'socket'")
    rdv = membership.new_rendezvous_dir()
    procs: List[subprocess.Popen] = []
    try:
        for r in range(nranks):
            env = dict(os.environ)
            env.update({ENV_RANK: str(r), ENV_SIZE: str(nranks),
                        ENV_RDV: rdv, ENV_BACKEND: backend})
            # the ranks import the same package this launcher runs from,
            # wherever the script lives
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
            if env_extra:
                env.update(env_extra)
            procs.append(subprocess.Popen([sys.executable, *argv], env=env))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                _kill_all(procs)
                sys.stderr.write(_exit_summary(procs))
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                _kill_all(procs)
                sys.stderr.write(_exit_summary(procs))
                raise TimeoutError(f"ranks still running after {timeout}s")
            time.sleep(0.02)
    finally:
        _kill_all(procs)
        membership.cleanup_rendezvous(rdv)


def _kill_all(procs: List[subprocess.Popen]) -> None:
    """TERM → bounded wait → KILL → reap.  The escalation matters: a rank
    wedged in native code (a stuck device call) ignores SIGTERM; the final
    wait reaps the KILLed zombies so the exit summary reports real wait
    statuses."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 5.0
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.send_signal(signal.SIGKILL)
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(2.0)
            except subprocess.TimeoutExpired:  # pragma: no cover - kernel
                pass  # unkillable (D-state); the summary reports it


def _exit_summary(procs: List[subprocess.Popen]) -> str:
    """Per-rank outcome table, printed on any non-zero outcome so a
    failure-story log is diagnosable without spelunking: WHICH rank died
    first-order (its own exit code / signal) vs which were merely killed
    by the launcher's TERM→KILL escalation."""
    lines = ["mpi_tpu_torch.launcher: per-rank exit summary:"]
    for r, p in enumerate(procs):
        code = p.poll()
        if code is None:
            what = "still running (unkillable?)"
        elif code < 0:
            try:
                name = signal.Signals(-code).name
            except ValueError:
                name = f"signal {-code}"
            what = f"killed by {name}"
        else:
            what = f"exit code {code}"
        lines.append(f"  rank {r}: {what}")
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="mpi_tpu_torch.launcher",
        description="mpirun-alike launcher for mpi_tpu_torch")
    parser.add_argument("-n", "--np", type=int, required=True, dest="nranks",
                        help="number of rank processes")
    parser.add_argument("--timeout", type=float, default=None,
                        help="kill all ranks after this many seconds")
    parser.add_argument("--backend", choices=("socket", "shm"), default=None,
                        help="rank transport (default: MPI_TPU_BACKEND or "
                             "socket; shm is not ported yet)")
    parser.add_argument("--restarts", type=int, default=0,
                        help="relaunch the world up to N times after a "
                             "crash/hang")
    parser.add_argument("--device", default=None,
                        help="device of every rank ('cpu', or a card such as "
                             "'cuda:0'); default: card rank %% device_count")
    parser.add_argument("script", help="python script to run on every rank")
    parser.add_argument("script_args", nargs=argparse.REMAINDER,
                        help="arguments passed to the script")
    args = parser.parse_args(argv)
    return launch(args.nranks, [args.script, *args.script_args],
                  timeout=args.timeout, backend=args.backend,
                  restarts=args.restarts, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
