"""Tuning-table sweep and validator — the port's counterpart of the
reference's ``tools/tune.py``.

Sweep mode (default) measures, for each transport, each group size and
each collective (``allreduce``, ``reduce_scatter``, ``alltoall``), the
per-call time of every applicable algorithm at each payload size — the
shared-memory arena ``"sm"`` included wherever the payload fits a slot —
and on shm the arena's two internal gates (``sm_allreduce``: flat vs
chunked folds; ``sm_reduce``: arena vs tree).  ``local`` is measured on
rank threads in this process (``transport.local.run_local``), which is
what a local world is; ``socket`` and ``shm`` under the port's launcher,
one process per rank, as their worlds run.  A process transport launches
one world of the largest group size and measures each smaller size on the
split of its lowest ranks while the others wait at a barrier.  The
launcher starts one process for it, which imports torch and the package
once and forks the world's rank processes (importing torch is most of a
rank process's start).  Those processes start with the sweep and import
while the local legs run; a world forks its ranks only when the legs
before it have ended, so no two legs measure at once.  The table's
``generated.parts_s`` holds the sweep's parts: each local leg, and for
each launched world its import, when the legs before it let it go, each
rank's fork, CUDA context and ``init()``, each band and the teardown.  Tensors
live on the card unless ``--device cpu`` is given.  It emits a table in
the ``tuning`` format: one row per (transport, nranks, collective, payload
band), the bands from ``tuning.band_edges``, each row trust-stamped
(untrusted when the ranks and the sweep outnumber the cores) and biased
toward the seed policy: when the algorithm the built-in constants would
pick is within ``--tie-factor`` of the fastest, the row keeps the seed's
choice.  The measured medians land in each row.

The measuring worlds are table-blind: the active table is cleared for the
sweep (and never set in a rank process), so an arena gate is measured as
itself.

Check mode (``--check table.json ...``) validates tables strictly and
says whether each would serve on this machine.

Usage::

    python -m mpi_tpu_torch.tools.tune --out table.json
    python -m mpi_tpu_torch.tools.tune --device cpu --ranks 2 --sizes 1024
    python -m mpi_tpu_torch.tools.tune --check table.json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import statistics
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import coll_sm as _coll_sm
from .. import communicator as _communicator
from .. import schedules
from ..membership import ENV_RANK, ENV_SIZE
from .. import tuning as _tuning
from ..tuning import table as _table

TRANSPORTS = ("local", "socket", "shm")
PROCESS_TRANSPORTS = ("socket", "shm")  # measured under the launcher
RANKS = (2, 3, 4)
SIZES = (1 << 10, 64 << 10, 1 << 20)
COLLECTIVES = ("allreduce", "reduce_scatter", "alltoall")
TIE_FACTOR = 1.10


def arena_capacity(p: int) -> int:
    """The largest payload ``algorithm="sm"`` serves for a P-rank group:
    the arena's own slot arithmetic, read live."""
    slot = ((_coll_sm._ARENA_BYTES - _coll_sm._LINE * p) // p) \
        // _coll_sm._LINE * _coll_sm._LINE
    return slot - _coll_sm._META_MAX


def seed_policy(transport: str, p: int, coll: str, nbytes: int) -> str:
    """What the built-in constants pick for one cell (the tie-bias
    incumbent): the arena first on shm where the payload fits, else the
    communicator's own wire policy."""
    sm_ok = transport == "shm" and nbytes <= arena_capacity(p)
    if coll == "alltoall":
        return "sm" if sm_ok else "pairwise"
    if coll == "reduce_scatter":
        return "sm" if sm_ok else "ring"
    if sm_ok:
        return "sm"
    return _communicator.seed_allreduce_algorithm(nbytes, p)


def gate_seed(coll: str, nbytes: int) -> str:
    eager = nbytes <= _coll_sm._EAGER_BYTES
    if coll == "sm_allreduce":
        return "flat" if eager else "chunked"
    return "arena" if eager else "tree"


def algorithms(transport: str, p: int, coll: str, nbytes: int) -> List[str]:
    """The algorithms measured for one cell ("sm" only where it serves)."""
    if coll == "allreduce":
        algos = ["ring", "rabenseifner", "reduce_bcast"]
        if schedules.is_pow2(p):
            algos.append("recursive_halving")
    elif coll == "reduce_scatter":
        algos = ["ring"]
    else:
        algos = ["pairwise"]
    if transport == "shm" and nbytes <= arena_capacity(p):
        algos.append("sm")
    return algos


def _elems(nbytes: int, p: int, coll: str) -> int:
    """float32 elements for a nominal size; block-splitting collectives
    get a multiple of P so their blocks stay congruent."""
    n = max(1, nbytes // 4)
    if coll in ("reduce_scatter", "alltoall"):
        n = max(p, n - n % p)
    return n


def _median_ms(comm, fn, iters: int) -> float:
    """Median per-call ms of ``iters`` calls after one warm-up."""
    cuda = comm.device.type == "cuda"
    times = []
    for i in range(1 + iters):
        comm.barrier(algorithm="dissemination")
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(comm.device)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _leg(comm, transport: str, sizes: Sequence[int], iters: int) -> Dict:
    """One world's measurements: {(coll, size): {algorithm: ms}} as seen
    by rank 0 (every rank runs the same calls)."""
    p, r = comm.size, comm.rank
    gen = torch.Generator().manual_seed(1234 + r)
    out: Dict[Tuple[str, int], Dict[str, float]] = {}
    for s in sizes:
        for coll in COLLECTIVES:
            n = _elems(s, p, coll)
            x = torch.randn(n, generator=gen).to(comm.device)
            cell = out.setdefault((coll, s), {})
            for algo in algorithms(transport, p, coll, n * 4):
                if coll == "allreduce":
                    fn = (lambda a=algo: comm.allreduce(x, algorithm=a))
                elif coll == "reduce_scatter":
                    blocks = x.view(p, -1)
                    fn = (lambda a=algo: comm.reduce_scatter(blocks,
                                                             algorithm=a))
                else:
                    blocks = x.view(p, -1)
                    fn = (lambda a=algo: comm.alltoall(blocks, algorithm=a))
                cell[algo] = _median_ms(comm, fn, iters)
        if transport != "shm" or s > arena_capacity(p):
            continue
        # the arena's internal gates, each side forced in turn (every rank
        # sets the module's gate between barriers: rank threads share it,
        # rank processes each have their own)
        x = torch.randn(max(1, s // 4), generator=gen).to(comm.device)
        saved = _coll_sm._EAGER_BYTES
        for gate, side, eager, coll, algo in (
                ("sm_allreduce", "flat", 1 << 62, "allreduce", "sm"),
                ("sm_allreduce", "chunked", 0, "allreduce", "sm"),
                ("sm_reduce", "arena", 1 << 62, "reduce", "sm"),
                ("sm_reduce", "tree", saved, "reduce", "tree")):
            fn = (lambda call=getattr(comm, coll), a=algo:
                  call(x, algorithm=a))
            comm.barrier(algorithm="dissemination")
            _coll_sm._EAGER_BYTES = eager
            comm.barrier(algorithm="dissemination")
            out.setdefault((gate, s), {})[side] = _median_ms(comm, fn, iters)
        comm.barrier(algorithm="dissemination")
        _coll_sm._EAGER_BYTES = saved
        comm.barrier(algorithm="dissemination")
    return out


def _process_leg(transport: str, ranks: Sequence[int], sizes: Sequence[int],
                 iters: int, out_path: str) -> None:
    """A rank process of a launched sweep world: measure each group size
    on the split of the world's lowest ranks (the rest wait at the world
    barrier); world rank 0 writes ``{nranks: [[coll, size, {algo: ms}],
    ...]}`` to ``out_path``, and every rank the wall-clock times of its
    start, its CUDA context, its ``init()`` and each band to
    ``<out_path>.<rank>``."""
    import mpi_tpu_torch

    stamps = {"start": time.time()}
    dev = mpi_tpu_torch._rank_device(int(os.environ[ENV_RANK]))
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the CUDA context
    stamps["cuda"] = time.time()
    comm = mpi_tpu_torch.init()
    stamps["init"] = time.time()
    if comm._t.tuning_transport != transport:
        raise RuntimeError(f"tune leg for {transport!r} runs on a "
                           f"{comm._t.tuning_transport!r} world")
    measured, bands = {}, {}
    for p in ranks:
        t0 = time.time()
        sub = comm.split(0 if comm.rank < p else None)
        if sub is not None:
            cells = _leg(sub, transport, sizes, iters)
            measured[p] = [[c, s, algs] for (c, s), algs in cells.items()]
            sub.free()
        comm.barrier()
        bands[p] = [t0, time.time()]
    stamps["bands"] = bands
    stamps["end"] = time.time()
    if comm.rank == 0:
        _write_json(out_path, measured)
    _write_json(f"{out_path}.{comm.rank}", stamps)
    mpi_tpu_torch.finalize()


def _write_json(path: str, doc) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def _leg_world(transport: str, ranks: Sequence[int], sizes: Sequence[int],
               iters: int, out_path: str) -> int:
    """The one process the launcher starts for a sweep world: torch and the
    package are imported, and it never touches the card, so once the sweep
    lets it go (``<out_path>.go`` exists) it forks the world's
    ``max(ranks)`` rank processes (``MPI_TPU_RANK`` and ``MPI_TPU_SIZE``
    set in each), each of which makes its own CUDA context; it forks none
    if the sweep gives up on it (``<out_path>.abort``).  Returns the first
    nonzero exit code of a rank (the others are then killed), else 0."""
    n = max(ranks)
    _write_json(f"{out_path}.imported", time.time())
    while not os.path.exists(f"{out_path}.go"):
        if os.path.exists(f"{out_path}.abort"):
            return 0
        time.sleep(0.01)
    pids = []

    def stop(signum, frame):  # the launcher's kill: take the ranks along
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, stop)
    sys.stdout.flush()
    sys.stderr.flush()
    for r in range(n):
        pid = os.fork()
        if pid == 0:  # a rank: it leaves by os._exit, as a forked child does
            code = 1
            try:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.environ.update({ENV_RANK: str(r), ENV_SIZE: str(n)})
                _process_leg(transport, ranks, sizes, iters, out_path)
                code = 0
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        pids.append(pid)
    code, live = 0, set(pids)
    while live:
        pid, status = os.wait()
        live.discard(pid)
        rc = os.waitstatus_to_exitcode(status)
        if rc and not code:
            code = rc if rc > 0 else 128 - rc
            for other in live:
                os.kill(other, signal.SIGKILL)
    return code


class _LaunchedWorld:
    """One launched world of ``max(ranks)`` rank processes on ``transport``,
    started at once (its process imports meanwhile) and let go by
    ``result()``, which returns ({nranks: {(coll, size): {algo: ms}}}, its
    parts in seconds: from the launch to the imports and to the go, each
    rank's fork, CUDA context and ``init()``, each band on rank 0 and the
    teardown); ``abort()`` ends it unmeasured."""

    def __init__(self, transport: str, ranks: Sequence[int], sizes: Sequence[int],
                 iters: int, device) -> None:
        from .. import launcher

        self.transport, self.n = transport, max(ranks)
        self.tmp = tempfile.mkdtemp(prefix="mpi_tpu_torch_tune_")
        self.out = os.path.join(self.tmp, "cells.json")
        argv = ["-m", "mpi_tpu_torch.tools.tune", "--leg", transport,
                "--leg-out", self.out, "--ranks", ",".join(map(str, ranks)),
                "--sizes", ",".join(map(str, sizes)), "--iters", str(iters)]
        self.rc: List = []
        self.launched = time.time()
        self.thread = threading.Thread(target=lambda: self.rc.append(launcher.launch(
            1, argv, timeout=600.0, backend=transport, device=str(device))), daemon=True)
        self.thread.start()

    def result(self) -> Tuple[Dict[int, Dict], Dict]:
        try:
            go = time.time()
            _write_json(self.out + ".go", go)
            self.thread.join()
            ended = time.time()
            if self.rc != [0]:
                raise RuntimeError(f"tune: the {self.transport} sweep world exited "
                                   f"{self.rc[0] if self.rc else 'with an error'}")
            with open(self.out) as f:
                measured = json.load(f)
            with open(self.out + ".imported") as f:
                imported = json.load(f)
            stamps = []
            for r in range(self.n):
                with open(f"{self.out}.{r}") as f:
                    stamps.append(json.load(f))
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        start = max(imported, go)
        parts = {"imports": round(imported - self.launched, 3),
                 "go": round(go - self.launched, 3),
                 "ranks": [{"fork": round(st["start"] - start, 3),
                            "cuda": round(st["cuda"] - st["start"], 3),
                            "init": round(st["init"] - st["cuda"], 3)} for st in stamps],
                 "bands": {p: round(b - a, 3) for p, (a, b) in stamps[0]["bands"].items()},
                 "teardown": round(ended - max(st["end"] for st in stamps), 3)}
        return ({int(p): {(c, s): algs for c, s, algs in cells}
                 for p, cells in measured.items()}, parts)

    def abort(self) -> None:
        _write_json(self.out + ".abort", time.time())
        self.thread.join()
        shutil.rmtree(self.tmp, ignore_errors=True)


def _rows(transport: str, p: int, cells: Dict, sizes: Sequence[int],
          trusted: bool, tie_factor: float) -> List[_table.Row]:
    rows = []
    for coll in COLLECTIVES + ("sm_allreduce", "sm_reduce"):
        measured = [s for s in sizes if cells.get((coll, s))]
        for lo, hi, s in _table.band_edges(measured):
            algs = cells[(coll, s)]
            winner = min(algs, key=algs.get)
            seed = (gate_seed(coll, s) if coll.startswith("sm_")
                    else seed_policy(transport, p, coll,
                                     _elems(s, p, coll) * 4))
            chosen = winner
            if (seed in algs and winner != seed
                    and algs[seed] <= tie_factor * algs[winner]):
                chosen = seed  # stability bias: noise never flips dispatch
            rows.append(_table.Row(
                transport, p, coll, lo, hi, chosen, trusted,
                extra={"measured_bytes": s,
                       "median_ms": {a: round(v, 4)
                                     for a, v in sorted(algs.items())},
                       "seed": seed}))
    return rows


def sweep(transports: Sequence[str] = TRANSPORTS,
          ranks: Sequence[int] = RANKS, sizes: Sequence[int] = SIZES,
          device=None, iters: int = 5,
          tie_factor: float = TIE_FACTOR) -> Dict:
    """Run the grid and assemble the table document."""
    from ..gpu.runner import resolve_device
    from ..transport.local import run_local

    device = resolve_device(device)
    ncpu = os.cpu_count() or 1
    t0 = time.perf_counter()
    saved_table = _tuning.table_path()
    _tuning.set_table_path(None)  # the measuring worlds are table-blind
    rows: List[_table.Row] = []
    parts: Dict[str, Dict] = {}
    for transport in transports:
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r} "
                             f"(accepted: {', '.join(TRANSPORTS)})")
    worlds = {t: _LaunchedWorld(t, ranks, sizes, iters, device)
              for t in transports if t in PROCESS_TRANSPORTS}
    try:
        for transport in transports:
            if transport in PROCESS_TRANSPORTS:
                # every rank of the launched world is a process, the idle
                # ones included
                world = max(ranks)
                cells_by_p, parts[transport] = worlds.pop(transport).result()
                for p, cells in sorted(cells_by_p.items()):
                    rows += _rows(transport, p, cells, sizes,
                                  (world + 1) <= ncpu, tie_factor)
            elif transport == "local":
                parts[transport] = {}
                for p in ranks:
                    t_leg = time.perf_counter()
                    res = run_local(_leg, p, args=(transport, tuple(sizes),
                                                   iters),
                                    device=device, timeout=600.0)
                    parts[transport][p] = round(time.perf_counter() - t_leg, 3)
                    rows += _rows(transport, p, res[0], sizes,
                                  (p + 1) <= ncpu, tie_factor)
    finally:
        for w in worlds.values():  # not reached: a leg before it failed
            w.abort()
        _tuning.set_table_path(saved_table or None)
    return _table.new_doc(rows, transports, generated={
        "tool": "mpi_tpu_torch.tools.tune",
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "ranks": list(ranks), "sizes": list(sizes), "iters": iters,
        "tie_factor": tie_factor, "cpus": ncpu,
        "ranks_as": {t: "processes" if t in PROCESS_TRANSPORTS else "threads"
                     for t in transports},
        "wall_s": round(time.perf_counter() - t0, 3),
        "parts_s": parts,
    })


def check(paths: Sequence[str]) -> int:
    """--check: strict validation; nonzero exit on the first bad table."""
    rc = 0
    for path in paths:
        try:
            tab = _table.TuningTable.load(path)
        except _table.TuningTableError as e:
            print(f"tune --check: FAIL {e}")
            rc = 1
            continue
        trusted = sum(1 for r in tab.rows if r.trusted)
        active = ("active here" if tab.matches_machine() else
                  "inactive here (another machine's fingerprint)")
        print(f"tune --check: OK {path}: {len(tab.rows)} rows "
              f"({trusted} trusted), fingerprint "
              f"{tab.fingerprint.get('hostname')}/"
              f"{tab.fingerprint.get('cpu_count')}cpu — {active}")
    return rc


def _ints(text: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in text.split(",") if v)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="mpi_tpu_torch.tools.tune",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", nargs="+", metavar="TABLE", default=None,
                    help="validate table(s) instead of sweeping")
    ap.add_argument("--out", default=None,
                    help="write the table here (default: stdout only)")
    ap.add_argument("--transports", default=",".join(TRANSPORTS))
    ap.add_argument("--ranks", default=",".join(map(str, RANKS)))
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="nominal payload bytes, comma separated")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tie-factor", type=float, default=TIE_FACTOR)
    ap.add_argument("--device", default=None,
                    help="'cpu' or a card (default: the card)")
    ap.add_argument("--leg", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--leg-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.check is not None:
        return check(args.check)
    if args.leg is not None:  # the process of a launched sweep world
        code = _leg_world(args.leg, _ints(args.ranks), _ints(args.sizes),
                          args.iters, args.leg_out)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)  # its ranks have ended; no interpreter teardown
    doc = sweep(tuple(args.transports.split(",")), _ints(args.ranks),
                _ints(args.sizes), device=args.device, iters=args.iters,
                tie_factor=args.tie_factor)
    _table.validate(doc)  # the generator never emits a bad table
    text = json.dumps(doc, indent=2)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"tune: wrote {args.out} ({len(doc['rows'])} rows, "
              f"{doc['generated']['wall_s']} s)")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
