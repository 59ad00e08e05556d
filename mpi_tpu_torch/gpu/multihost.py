"""Worlds that span processes: one SPMD world over every process's ranks.

Counterpart of ``mpi_tpu/tpu/multihost.py``.  There one process runs per
host, ``jax.distributed.initialize()`` wires them into one runtime and a
``Mesh`` over the global device list makes every communicator span hosts.
Here ``init_distributed`` joins a ``torch.distributed`` gloo process group
(the host barrier and, on the CPU, the data path), each process holds
``ranks per process`` virtual ranks of the world, and a ``Mesh`` hands out
``TorchCommunicator``s whose world spans the processes: ``run_spmd`` maps
over this process's ranks and the world-level rules gather the others'
through ``gpu/peers.py`` (gloo on the CPU, CUDA IPC on the card, where the
ring kernel reads the peers' memory in place).

Axis layout as in the reference: heavy, latency-sensitive collectives on
the inner (``ici``) axes, which stay inside one process; bandwidth-tolerant
ones on the outer (``dcn``) axes, which cross processes.  ``hybrid_mesh``
builds that split; the process is the granule, as on the reference's CPU
and simulated hosts.

Simulated hosts on one machine::

    python -m mpi_tpu_torch.gpu.multihost -n 2 --devices-per-host 2 \\
        [--device cpu] [--timeout S] script.py [args]

starts one process per "host"; ``auto_init()`` + ``global_mesh()`` inside
the script are all it needs.  Each process takes card ``host %
device_count`` (two processes share a one-card machine's card) unless
``--device cpu``; the choice travels in ``MPI_TPU_DEVICE``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..membership import ENV_DEVICE
from . import primitives
from .communicator import TorchCommunicator
from .runner import resolve_device

ENV_COORD = "MPI_TPU_COORD"
ENV_NPROCS = "MPI_TPU_NPROCS"
ENV_PROC_ID = "MPI_TPU_PROC_ID"
# ranks each process holds (the launcher's --devices-per-host)
ENV_RANKS = "MPI_TPU_RANKS_PER_HOST"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the multi-process world (idempotent: a second call keeps the
    first).  Without arguments the simulated-host launcher's environment is
    read, else ``torch.distributed``'s own (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``: ``init_method="env://"``).  The group is gloo, on the card
    too: it carries the host barriers and the IPC handles."""
    if dist.is_initialized():
        return
    if coordinator_address is None and os.environ.get(ENV_COORD):
        coordinator_address = os.environ[ENV_COORD]
        num_processes = int(os.environ[ENV_NPROCS])
        process_id = int(os.environ[ENV_PROC_ID])
    if coordinator_address is None:
        dist.init_process_group("gloo", init_method="env://")
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))


def auto_init() -> bool:
    """``init_distributed`` from the environment the simulated-host
    launcher sets (a no-op without it: one process).  True iff
    multi-process."""
    if not os.environ.get(ENV_COORD):
        return False
    init_distributed()
    return True


def process_count() -> int:
    """Processes in the world (``jax.process_count``); 1 before init."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's index (``jax.process_index``); 0 before init."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank_count() -> int:
    """Ranks this process holds (``jax.local_device_count``): the
    launcher's ``--devices-per-host``, else 1."""
    return int(os.environ.get(ENV_RANKS, "1"))


def device(device=None) -> torch.device:
    """This process's device: ``device`` when given, else the launcher's
    ``MPI_TPU_DEVICE``, else card ``process_index() % device_count``.
    Without a card and without ``"cpu"`` it raises (never a fallback)."""
    if device is None:
        device = os.environ.get(ENV_DEVICE) or None
    if device is None and torch.cuda.is_available():
        device = f"cuda:{process_index() % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


class Mesh:
    """A grid of the world's global ranks with named axes (the port's
    ``jax.sharding.Mesh``).  ``ranks[...]`` is a rank number, the index of
    its row in the world; process ``q`` holds ranks ``[q * L, (q + 1) * L)``
    for ``L = ranks_per_process``.  ``comm(axis)`` is the communicator
    along one axis: its groups are that axis's lines of the grid, as
    ``TpuCommunicator(axis, mesh)`` takes them."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 ranks_per_process: int, nprocs: int, process: int):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.ranks_per_process = ranks_per_process
        self.nprocs = nprocs
        self.process = process

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def process_index(self) -> np.ndarray:
        """The process that holds each rank of the grid."""
        return self.ranks // self.ranks_per_process

    @property
    def span(self) -> Optional[primitives.Span]:
        """This process's ranks, where the world spans processes."""
        if self.nprocs == 1:
            return None
        return primitives.Span(self.process * self.ranks_per_process,
                               self.ranks_per_process)

    def comm(self, axis: Optional[str] = None) -> TorchCommunicator:
        """The communicator along ``axis`` (default: the only axis)."""
        if axis is None:
            if len(self.axis_names) != 1:
                raise ValueError(f"name one of the axes {self.axis_names}")
            axis = self.axis_names[0]
        lines = np.moveaxis(self.ranks, self.axis_names.index(axis), -1)
        groups = lines.reshape(-1, lines.shape[-1]).tolist()
        if groups == [list(range(self.size))]:
            groups = None
        return TorchCommunicator(self.size, groups, self.span)


def _mesh(ranks: np.ndarray, axis_names) -> Mesh:
    return Mesh(ranks, axis_names, local_rank_count(), process_count(),
                process_index())


def global_mesh(axis_name: str = "world") -> Mesh:
    """The 1-D mesh over every process's ranks: MPI_COMM_WORLD for the
    whole set of hosts."""
    return _mesh(np.arange(process_count() * local_rank_count()), (axis_name,))


def hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                axis_names: Tuple[str, ...]) -> Mesh:
    """ICI x DCN mesh: ``ici_shape`` partitions each process's ranks
    (inner, one process along each ici line), ``dcn_shape`` spans the
    processes (outer).  Axis i has ``ici_shape[i] * dcn_shape[i]`` ranks,
    laid out as the reference's ``create_hybrid_device_mesh`` lays them
    (``np.block`` of the processes' blocks)."""
    if len(ici_shape) != len(dcn_shape) or len(ici_shape) != len(axis_names):
        raise ValueError(
            f"ici_shape {ici_shape}, dcn_shape {dcn_shape} and axis_names "
            f"{axis_names} must have one entry per mesh axis")
    nprocs, local = process_count(), local_rank_count()
    if all(d == 1 for d in dcn_shape):
        # one granule: the plain grid (the same layout contract)
        if int(np.prod(ici_shape)) != nprocs * local:
            raise ValueError(f"ici_shape {tuple(ici_shape)} needs "
                             f"{int(np.prod(ici_shape))} ranks; the world has "
                             f"{nprocs * local}")
        return _mesh(np.arange(nprocs * local).reshape(tuple(ici_shape)),
                     axis_names)
    if int(np.prod(dcn_shape)) != nprocs or int(np.prod(ici_shape)) != local:
        raise ValueError(
            f"dcn_shape {tuple(dcn_shape)} must cover the {nprocs} processes "
            f"and ici_shape {tuple(ici_shape)} each process's {local} ranks")
    nd = len(ici_shape)
    # blocks[d..., i...]: rank i of the process at dcn position d
    blocks = (np.arange(nprocs).reshape(tuple(dcn_shape) + (1,) * nd) * local
              + np.arange(local).reshape((1,) * nd + tuple(ici_shape)))
    order = [a for k in range(nd) for a in (k, nd + k)]
    grid = blocks.transpose(order).reshape(
        tuple(d * i for d, i in zip(dcn_shape, ici_shape)))
    return _mesh(grid, axis_names)


def shutdown() -> None:
    """Close the peer exchange (IPC mappings, staging) and leave the
    process group."""
    from . import peers

    peers.destroy()
    if dist.is_initialized():
        dist.destroy_process_group()


# ---- simulated-host launcher ---------------------------------------------


def _stop(procs) -> None:
    """Terminate the survivors and reap every child."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except Exception:  # noqa: BLE001 - a child that ignores TERM
            p.kill()
            p.wait()


def launch_sim_hosts(nhosts: int, argv: Sequence[str],
                     devices_per_host: int = 2,
                     timeout: Optional[float] = None,
                     device: Optional[str] = None) -> int:
    """Spawn ``nhosts`` processes running ``python argv...``, each holding
    ``devices_per_host`` ranks of one world (the script calls
    ``auto_init()``).  Returns the first nonzero exit code, else 0; raises
    ``TimeoutError`` past ``timeout``; terminates the survivors either
    way.  ``device="cpu"`` runs every process on the CPU; by default
    process h takes card ``h % device_count``."""
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as s:  # a free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    # the processes import the package this launcher runs from
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env[ENV_COORD] = f"127.0.0.1:{port}"
    env[ENV_NPROCS] = str(nhosts)
    env[ENV_RANKS] = str(devices_per_host)
    if device is not None:
        env[ENV_DEVICE] = device

    procs = []
    try:
        for pid in range(nhosts):
            penv = dict(env)
            penv[ENV_PROC_ID] = str(pid)
            procs.append(subprocess.Popen([sys.executable, *argv], env=penv))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"hosts still running after {timeout}s")
            time.sleep(0.02)
    finally:
        _stop(procs)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="mpi_tpu_torch.gpu.multihost",
        description="simulated multi-host launcher (one process per 'host', "
                    "each holding --devices-per-host ranks of one world)")
    parser.add_argument("-n", "--hosts", type=int, required=True)
    parser.add_argument("--devices-per-host", type=int, default=2)
    parser.add_argument("--device", default=None,
                        help="'cpu', or a card for every process (default: "
                             "card host %% device_count)")
    parser.add_argument("--timeout", type=float, default=None)
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    return launch_sim_hosts(args.hosts, [args.script, *args.script_args],
                            devices_per_host=args.devices_per_host,
                            timeout=args.timeout, device=args.device)


if __name__ == "__main__":
    import sys

    sys.exit(main())
