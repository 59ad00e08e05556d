"""The port's native host code: the same-host shm ring, its doorbells and
the collective arena's flag lines (``shmring.cpp``), built with ``g++`` on
first use into ``mpi_tpu_torch/_build/`` (``build.py``)."""

from .build import NativeBuildError, ensure_built, load_shmring

__all__ = ["NativeBuildError", "ensure_built", "load_shmring"]
