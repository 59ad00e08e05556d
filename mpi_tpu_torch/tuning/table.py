"""The versioned per-machine tuning-table format — the port's own copy of
``mpi_tpu/tuning/table.py`` (``FORMAT`` / ``VERSION`` :40, the closed
``KNOWN_ALGORITHMS`` :45, ``fingerprint`` :65, ``Row`` :82, the strict
``validate`` :130, ``TuningTable`` :205 with its trusted-first ``match``,
``band_edges`` :250 and ``new_doc`` :266).  Both packages accept and
refuse the same documents with the same messages.

A table maps ``(transport, nranks, collective, payload band [lo_bytes,
hi_bytes))`` to the algorithm a sweep (``python -m
mpi_tpu_torch.tools.tune``) measured fastest there, and activates only on
the machine it was measured on (hostname and cpu count).  The key has no
device: a table swept with tensors on the card serves the same rows to a
CPU run on that machine.  Untrusted rows (an oversubscribed sweep leg)
load and serve, but a trusted row matching the same request always wins.
The two ``sm_*`` pseudo-collectives are the collective arena's internal
gates (flat-vs-chunked fold in ``coll_sm.allreduce``, arena-vs-tree in
``coll_sm.reduce``).
"""

from __future__ import annotations

import json
import os
import socket as _socket
from typing import Any, Dict, List, Optional, Sequence

FORMAT = "mpi_tpu-tuning-table"
VERSION = 1

# collective -> algorithm names a row may carry.  "sm" routes the
# request to the shared-memory collective arena first (exactly auto's
# arena tier); the wire names match each collective's algorithm= gate.
KNOWN_ALGORITHMS: Dict[str, frozenset] = {
    "allreduce": frozenset({"ring", "recursive_halving", "rabenseifner",
                            "reduce_bcast", "sm"}),
    "reduce_scatter": frozenset({"ring", "sm"}),
    "alltoall": frozenset({"pairwise", "sm"}),
    # arena-internal gates (coll_sm.py): the flat-vs-chunked
    # fold split of the arena allreduce, and the arena-vs-binomial-tree
    # split of reduce — both formerly a single coll_sm_eager_bytes
    # constant for every machine.
    "sm_allreduce": frozenset({"flat", "chunked"}),
    "sm_reduce": frozenset({"arena", "tree"}),
}


class TuningTableError(ValueError):
    """A tuning table failed validation (malformed JSON, wrong version,
    unknown collective/algorithm, bad payload band...)."""


def fingerprint(transports: Sequence[str] = ("shm", "socket")) -> Dict:
    """THIS machine's identity stamp: tables only activate where they
    were measured (hostname + cpu count; the transport set is recorded
    so a table swept on one data plane is honest about its coverage)."""
    return {
        "hostname": _socket.gethostname(),
        "cpu_count": os.cpu_count() or 1,
        "transports": sorted(transports),
    }


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


class Row:
    """One dispatch decision: (transport, nranks, collective, band) ->
    algorithm.  ``hi_bytes=None`` means the band is open-ended."""

    __slots__ = ("transport", "nranks", "collective", "lo_bytes",
                 "hi_bytes", "algorithm", "trusted", "extra")

    def __init__(self, transport: str, nranks: int, collective: str,
                 lo_bytes: int, hi_bytes: Optional[int], algorithm: str,
                 trusted: bool, extra: Optional[Dict] = None):
        self.transport = transport
        self.nranks = nranks
        self.collective = collective
        self.lo_bytes = lo_bytes
        self.hi_bytes = hi_bytes
        self.algorithm = algorithm
        self.trusted = trusted
        self.extra = extra or {}

    def matches(self, transport: str, nranks: int, collective: str,
                nbytes: int) -> bool:
        return (self.transport == transport and self.nranks == nranks
                and self.collective == collective
                and self.lo_bytes <= nbytes
                and (self.hi_bytes is None or nbytes < self.hi_bytes))

    def as_dict(self) -> Dict:
        d = {"transport": self.transport, "nranks": self.nranks,
             "collective": self.collective, "lo_bytes": self.lo_bytes,
             "hi_bytes": self.hi_bytes, "algorithm": self.algorithm,
             "trusted": self.trusted}
        d.update(self.extra)
        return d

    def __repr__(self) -> str:  # pragma: no cover - diagnostics
        hi = "inf" if self.hi_bytes is None else self.hi_bytes
        return (f"Row({self.transport}, P={self.nranks}, "
                f"{self.collective}, [{self.lo_bytes}, {hi}) -> "
                f"{self.algorithm}, trusted={self.trusted})")


def _row_error(i: int, msg: str) -> TuningTableError:
    return TuningTableError(f"tuning table row {i}: {msg}")


def validate(doc: Any, path: str = "<table>") -> List[Row]:
    """Strict, total validation of a loaded table document; returns the
    rows in file order.  Raises :class:`TuningTableError` with the
    offending field — the message ``python -m mpi_tpu_torch.tools.tune --check`` prints."""
    if not isinstance(doc, dict):
        raise TuningTableError(
            f"{path}: tuning table must be a JSON object, got "
            f"{type(doc).__name__}")
    if doc.get("format") != FORMAT:
        raise TuningTableError(
            f"{path}: not a tuning table (format={doc.get('format')!r}, "
            f"want {FORMAT!r})")
    if doc.get("version") != VERSION:
        raise TuningTableError(
            f"{path}: stale/unknown table version {doc.get('version')!r} "
            f"(this build reads version {VERSION}; re-run tools/tune.py)")
    fp = doc.get("fingerprint")
    if not isinstance(fp, dict) or not isinstance(fp.get("hostname"), str) \
            or not isinstance(fp.get("cpu_count"), int) \
            or fp.get("cpu_count", 0) < 1 \
            or not isinstance(fp.get("transports"), list):
        raise TuningTableError(
            f"{path}: fingerprint must carry hostname(str), "
            f"cpu_count(int>=1) and transports(list), got {fp!r}")
    rows_doc = doc.get("rows")
    if not isinstance(rows_doc, list):
        raise TuningTableError(f"{path}: rows must be a list")
    rows: List[Row] = []
    for i, r in enumerate(rows_doc):
        if not isinstance(r, dict):
            raise _row_error(i, f"must be an object, got {type(r).__name__}")
        coll = r.get("collective")
        if coll not in KNOWN_ALGORITHMS:
            raise _row_error(i, f"unknown collective {coll!r}; accepted: "
                                f"{sorted(KNOWN_ALGORITHMS)}")
        algo = r.get("algorithm")
        if algo not in KNOWN_ALGORITHMS[coll]:
            raise _row_error(
                i, f"unknown {coll} algorithm {algo!r}; accepted: "
                   f"{sorted(KNOWN_ALGORITHMS[coll])}")
        transport = r.get("transport")
        if not isinstance(transport, str) or not transport:
            raise _row_error(i, f"transport must be a non-empty string, "
                                f"got {transport!r}")
        nranks = r.get("nranks")
        if not isinstance(nranks, int) or nranks < 2:
            raise _row_error(i, f"nranks must be an int >= 2, got {nranks!r}")
        if algo == "recursive_halving" and not _is_pow2(nranks):
            raise _row_error(
                i, f"recursive_halving only runs on power-of-two groups "
                   f"(nranks={nranks})")
        lo = r.get("lo_bytes")
        hi = r.get("hi_bytes")
        if not isinstance(lo, int) or lo < 0:
            raise _row_error(i, f"lo_bytes must be an int >= 0, got {lo!r}")
        if hi is not None and (not isinstance(hi, int) or hi <= lo):
            raise _row_error(
                i, f"hi_bytes must be null (open-ended) or an int > "
                   f"lo_bytes={lo}, got {hi!r}")
        trusted = r.get("trusted")
        if not isinstance(trusted, bool):
            raise _row_error(i, f"trusted must be a bool, got {trusted!r}")
        extra = {k: v for k, v in r.items()
                 if k not in ("transport", "nranks", "collective",
                              "lo_bytes", "hi_bytes", "algorithm",
                              "trusted")}
        rows.append(Row(transport, nranks, coll, lo, hi, algo, trusted,
                        extra))
    return rows


class TuningTable:
    """A validated, matchable tuning table."""

    def __init__(self, doc: Dict, rows: List[Row],
                 path: Optional[str] = None):
        self.doc = doc
        self.rows = rows
        self.path = path

    @property
    def fingerprint(self) -> Dict:
        return self.doc["fingerprint"]

    @classmethod
    def from_doc(cls, doc: Any, path: str = "<table>") -> "TuningTable":
        return cls(doc, validate(doc, path), path=None if path.startswith("<")
                   else path)

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        try:
            with open(path) as f:
                doc = json.load(f)
        except OSError as e:
            raise TuningTableError(f"{path}: cannot read table: {e}") from e
        except json.JSONDecodeError as e:
            raise TuningTableError(f"{path}: not valid JSON: {e}") from e
        return cls(doc, validate(doc, path), path=path)

    def matches_machine(self, fp: Optional[Dict] = None) -> bool:
        """True iff the table was measured on THIS machine (hostname +
        cpu count).  A mismatched table stays loaded but inactive — the
        resolver falls back to the seed constants."""
        fp = fp or fingerprint()
        mine = self.fingerprint
        return (mine.get("hostname") == fp["hostname"]
                and mine.get("cpu_count") == fp["cpu_count"])

    def match(self, transport: str, nranks: int, collective: str,
              nbytes: int) -> Optional[Row]:
        """The winning row for one dispatch decision: TRUSTED rows
        always beat untrusted ones; within a trust class, file order
        decides (the sweep emits non-overlapping bands)."""
        fallback: Optional[Row] = None
        for row in self.rows:
            if not row.matches(transport, nranks, collective, int(nbytes)):
                continue
            if row.trusted:
                return row
            if fallback is None:
                fallback = row
        return fallback


def band_edges(sizes: Sequence[int]) -> List[tuple]:
    """Payload bands from a measured size grid: size k governs
    [size_k, size_{k+1}), the first band reaches down to 0 and the last
    is open-ended — every possible payload lands in exactly one band."""
    ss = sorted(set(int(s) for s in sizes))
    if not ss:
        return []
    out = []
    for i, s in enumerate(ss):
        lo = 0 if i == 0 else s
        hi = ss[i + 1] if i + 1 < len(ss) else None
        out.append((lo, hi, s))
    return out


def new_doc(rows: List[Row], transports: Sequence[str],
            generated: Optional[Dict] = None) -> Dict:
    """Assemble a writable table document (the sweep tool's emit side)."""
    return {
        "format": FORMAT,
        "version": VERSION,
        "fingerprint": fingerprint(transports),
        "generated": generated or {},
        "rows": [r.as_dict() for r in rows],
    }


__all__ = ["FORMAT", "VERSION", "KNOWN_ALGORITHMS", "TuningTableError",
           "Row", "TuningTable", "fingerprint", "validate", "band_edges",
           "new_doc"]
