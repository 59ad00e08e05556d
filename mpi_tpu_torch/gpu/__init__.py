"""The SPMD backend on one CUDA card (counterpart of ``mpi_tpu/tpu``)."""

from .communicator import SpmdSemanticsError, TorchCommunicator
from .primitives import SpmdContextError, rank_normal, rank_uniform
from .runner import resolve_device, run_spmd

__all__ = ["SpmdContextError", "SpmdSemanticsError", "TorchCommunicator",
           "rank_normal", "rank_uniform", "resolve_device", "run_spmd"]
