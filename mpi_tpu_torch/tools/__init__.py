"""The port's own tools: ``python -m mpi_tpu_torch.tools.mpilint`` (the
static MPI linter), ``python -m mpi_tpu_torch.tools.tracecat`` (the
per-rank trace merger), ``python -m mpi_tpu_torch.tools.tune`` (the
tuning-table sweep) and ``python -m mpi_tpu_torch.tools.gpu_evidence``
(the evidence record of the port on the card)."""
