"""The rendezvous directory — the part of ``mpi_tpu/membership.py`` the
launcher (``launcher.py``) and the socket bootstrap use:
``new_rendezvous_dir`` (:569), port publication and ``cleanup_rendezvous``
(:575).

Each socket rank binds an OS-assigned port and publishes it as
``<rdv>/port.<rank>`` (written to a temporary name, then renamed, so a
reader never sees a partial file); peers poll for it.  Heartbeats,
incarnations, epochs and rejoin claims are fault-tolerance features, not
ported yet (ROADMAP 16.2).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

# The environment the launcher gives each rank process (the reference's
# names): ``init`` / ``run`` read it to build the rank's socket world.
ENV_RANK = "MPI_TPU_RANK"
ENV_SIZE = "MPI_TPU_SIZE"
ENV_RDV = "MPI_TPU_RDV"
ENV_BACKEND = "MPI_TPU_BACKEND"
ENV_DEVICE = "MPI_TPU_DEVICE"


def new_rendezvous_dir(prefix: str = "mpi_tpu_torch_rdv_") -> str:
    """Create a fresh rendezvous directory (under ``TMPDIR``)."""
    return tempfile.mkdtemp(prefix=prefix)


def publish_port(rdv_dir: str, rank: int, port: int) -> None:
    """Atomically publish ``rank``'s listening port."""
    tmp = os.path.join(rdv_dir, f".port.{rank}.tmp")
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, os.path.join(rdv_dir, f"port.{rank}"))


def read_port(rdv_dir: str, rank: int) -> Optional[int]:
    """The port ``rank`` published, or None while it has not."""
    try:
        with open(os.path.join(rdv_dir, f"port.{rank}")) as f:
            text = f.read().strip()
        return int(text) if text else None
    except (FileNotFoundError, ValueError):
        return None


def cleanup_rendezvous(rdv: str) -> None:
    """Tear a rendezvous directory down."""
    shutil.rmtree(rdv, ignore_errors=True)
