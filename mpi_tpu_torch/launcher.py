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

``--progress thread`` starts a progress engine in every rank
(``MPI_TPU_PROGRESS``); ``MPI_TPU_FT=1`` in the launcher's environment
enables fault tolerance in every rank (``ft.py``); ``--verify`` the
runtime verifier (``MPI_TPU_VERIFY=1``, :212) and ``--trace-dir DIR`` the
flight recorder, each rank exporting its Chrome trace into DIR at exit
(``MPI_TPU_TRACE`` / ``MPI_TPU_TRACE_DIR``, :235); ``--tuning-table PATH``
activates a tuned-dispatch table in every rank (``MPI_TPU_TUNING_TABLE``,
:264).  ``--backend shm`` runs the ranks over the native shared-memory
rings (``transport/shm.py``): the ring is built once up front (:92), and
the rendezvous teardown unlinks any segment a crashed rank left behind.
``--link-retry-timeout S`` sets every rank's socket link-healing budget
(``MPI_TPU_LINK_RETRY_S``, the ``link_retry_timeout_s`` cvar, :228).
``launcher serve ...`` runs the resident world server (``serve.main``,
:190-197), every option passed through, the federation's
``--federation``, ``--server-id``, ``--fed-lease-timeout`` and
``--orphan-timeout`` included; its workers take ``--device`` as the
ranks do.

Usage::

    python -m mpi_tpu_torch.launcher -n 4 prog.py [script args...]
    python -m mpi_tpu_torch.launcher -n 4 --backend shm prog.py
    python -m mpi_tpu_torch.launcher -n 4 --tuning-table t.json prog.py
    python -m mpi_tpu_torch.launcher -n 4 --device cpu prog.py
    MPI_TPU_FT=1 python -m mpi_tpu_torch.launcher -n 4 --progress thread prog.py
    python -m mpi_tpu_torch.launcher -n 4 --verify --trace-dir traces prog.py
    python -m mpi_tpu_torch.tools.tracecat traces -o merged.json
    python -m mpi_tpu_torch.launcher serve --pool-size 4 --addr-file F
    python -m mpi_tpu_torch.launcher serve --pool-size 2 --federation NS --server-id a
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
           device: Optional[str] = None,
           env_extra: Optional[dict] = None) -> int:
    """Run ``python argv...`` as ``nranks`` rank processes; return the exit
    code.  ``restarts``: after a nonzero exit or a hang (timeout), the
    WHOLE world is killed and relaunched up to this many times
    (``MPI_TPU_ATTEMPT`` carries the attempt number to the ranks).
    ``device`` (``"cpu"`` or a card) overrides every rank's default;
    ``env_extra`` is added to every rank's environment."""
    last = 0
    for attempt in range(restarts + 1):
        extra = dict(env_extra or {})
        extra["MPI_TPU_ATTEMPT"] = str(attempt)
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
    if backend not in ("socket", "shm"):
        raise ValueError(f"unknown launcher backend {backend!r} "
                         f"(accepted: socket, shm)")
    if backend == "shm":
        # build the native ring once, up front, instead of N ranks racing
        # to the build lock
        from .native import ensure_built

        ensure_built()
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
    wedged in native code (a ring memcpy, a stuck device call) ignores
    SIGTERM and keeps its /dev/shm segments mapped; the final
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
    if argv[:1] == ["serve"]:
        # the resident world server: warm workers leased as worlds in one
        # round trip, dead workers replaced under a new membership epoch
        from . import serve

        return serve.main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="mpi_tpu_torch.launcher",
        description="mpirun-alike launcher for mpi_tpu_torch (or "
                    "'... launcher serve' for the resident world server)")
    parser.add_argument("-n", "--np", type=int, required=True, dest="nranks",
                        help="number of rank processes")
    parser.add_argument("--timeout", type=float, default=None,
                        help="kill all ranks after this many seconds")
    parser.add_argument("--backend", choices=("socket", "shm"), default=None,
                        help="rank transport (default: MPI_TPU_BACKEND or "
                             "socket): TCP sockets, or the native "
                             "shared-memory rings")
    parser.add_argument("--restarts", type=int, default=0,
                        help="relaunch the world up to N times after a "
                             "crash/hang")
    parser.add_argument("--device", default=None,
                        help="device of every rank ('cpu', or a card such as "
                             "'cuda:0'); default: card rank %% device_count")
    parser.add_argument("--progress", choices=("none", "thread"), default=None,
                        help="progress mode of every rank (MPI_TPU_PROGRESS): "
                             "'thread' starts one progress engine per rank")
    parser.add_argument("--verify", action="store_true",
                        help="enable the runtime correctness verifier "
                             "(MPI_TPU_VERIFY=1 on every rank): deadlock "
                             "detection, collective-matching signatures, "
                             "request and buffer lints")
    parser.add_argument("--link-retry-timeout", type=float, default=None,
                        metavar="S",
                        help="socket link-healing budget of every rank "
                             "(MPI_TPU_LINK_RETRY_S, the "
                             "link_retry_timeout_s cvar): a send-path "
                             "OSError whose peer is not failure-suspected "
                             "reconnects with backoff for up to this many "
                             "seconds, replaying unacked frames; keep it "
                             "below fault_detect_timeout_s")
    parser.add_argument("--trace-dir", default=None, metavar="DIR",
                        help="enable the flight recorder on every rank "
                             "(MPI_TPU_TRACE=1) and export one Chrome-trace "
                             "JSON per rank into DIR at exit; merge them "
                             "with python -m mpi_tpu_torch.tools.tracecat "
                             "DIR -o merged.json")
    parser.add_argument("--tuning-table", default=None, metavar="PATH",
                        help="activate a tuned-dispatch table in every "
                             "rank (MPI_TPU_TUNING_TABLE): algorithm='auto' "
                             "consults its rows before the built-in "
                             "constants (mpi_tpu_torch/tuning)")
    parser.add_argument("script", help="python script to run on every rank")
    parser.add_argument("script_args", nargs=argparse.REMAINDER,
                        help="arguments passed to the script")
    args = parser.parse_args(argv)
    env_extra = {}
    if args.tuning_table is not None:
        env_extra["MPI_TPU_TUNING_TABLE"] = os.path.abspath(args.tuning_table)
    if args.verify:
        env_extra["MPI_TPU_VERIFY"] = "1"
    if args.progress is not None:
        env_extra["MPI_TPU_PROGRESS"] = args.progress
    if args.link_retry_timeout is not None:
        if args.link_retry_timeout <= 0:
            parser.error("--link-retry-timeout must be > 0 (the "
                         "reference's healing-off mode, 0, is not ported)")
        env_extra["MPI_TPU_LINK_RETRY_S"] = str(args.link_retry_timeout)
    if args.trace_dir is not None:
        env_extra["MPI_TPU_TRACE"] = "1"
        env_extra["MPI_TPU_TRACE_DIR"] = os.path.abspath(args.trace_dir)
    return launch(args.nranks, [args.script, *args.script_args],
                  timeout=args.timeout, backend=args.backend,
                  restarts=args.restarts, device=args.device,
                  env_extra=env_extra)


if __name__ == "__main__":
    sys.exit(main())
