"""The port's own tools: ``python -m mpi_tpu_torch.tools.mpilint`` (the
static MPI linter) and ``python -m mpi_tpu_torch.tools.tracecat`` (the
per-rank trace merger)."""
