"""Tuned dispatch — the port's own copy of ``mpi_tpu/tuning/``: measured
per-machine algorithm-selection tables (``table``) and the process-wide
``pick`` every ``algorithm="auto"`` decision consults (``resolver``).
The sweep that writes a table is ``python -m mpi_tpu_torch.tools.tune``
(``--check`` validates one)."""

from .resolver import (ENV_TABLE, active_table, explain, last_decision,
                       pick, reason, set_table_path, table_path)
from .table import (FORMAT, KNOWN_ALGORITHMS, VERSION, Row, TuningTable,
                    TuningTableError, band_edges, fingerprint, new_doc,
                    validate)

__all__ = [
    "ENV_TABLE", "active_table", "explain", "last_decision", "pick",
    "reason", "set_table_path", "table_path",
    "FORMAT", "KNOWN_ALGORITHMS", "VERSION", "Row", "TuningTable",
    "TuningTableError", "band_edges", "fingerprint", "new_doc", "validate",
]
