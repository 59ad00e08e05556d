"""Collective-matching verification: per-entry signatures, cross-checked
in-band before any collective data moves — the port's own copy of
``mpi_tpu/verify/collcheck.py`` (``geom_of``, ``signature``, ``check``,
``_differs``, on ``TAG_VERIFY = -9``).

A tensor's dtype is spelled as the reference spells a numpy dtype
(``float32``, ``bfloat16``), so a mismatch reads the same in both
packages; the device is not part of the signature, as the reference has
none.

Every verified collective entry computes a signature — (sequence number,
collective name, root, reduce op, payload-geometry class, algorithm,
vector counts) — and circulates it around the communicator's ring on the
reserved TAG_VERIFY channel (P-1 pipelined sendrecv steps, so EVERY rank
sees EVERY signature).  Any divergence — different collective order
across ranks, mismatched roots or reduce ops, mismatched reduce
geometry, truncating vector counts — raises
:class:`~mpi_tpu_torch.errors.CollectiveMismatchError` on every rank, naming
the lowest divergent rank pair, both signatures, and both call sites,
BEFORE the mismatched schedules can exchange a byte (the hang/misfold
never happens).

Geometry is compared only for the collectives whose contract requires
congruent payloads (reduce / allreduce / reduce_scatter / scan); ragged
allgather and root-only-knowledge bcast/scatter deliberately skip it.
A rank that diverged in collective COUNT (entered one fewer collective,
or exited) leaves its peers blocked in this exchange — which the
deadlock detector then diagnoses, naming the enclosing collective.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .. import mpit as _mpit
from ..errors import CollectiveMismatchError
from .state import report_add, user_site

# Reserved control tag of the signature exchange (negative: user
# wildcards can never match it — transport/base.py Mailbox._matches;
# -6/-7/-8 are ft.py's, -2..-4 the communicator's).
TAG_VERIFY = -9

# Collectives whose payload geometry must be congruent across ranks.
_GEOM_COLLS = frozenset({"reduce", "allreduce", "reduce_scatter", "scan"})


def geom_of(coll: str, payload: Any) -> Optional[Tuple]:
    """Geometry class of a reduction payload: (dtype, shape) for array
    payloads, a type marker otherwise; None = not compared (non-uniform
    collective, or rank-local knowledge only)."""
    if coll not in _GEOM_COLLS or payload is None:
        return None
    if hasattr(payload, "dtype") and hasattr(payload, "shape"):
        return (str(payload.dtype).replace("torch.", ""),
                tuple(int(s) for s in payload.shape))
    return (type(payload).__name__,)


def signature(seq: int, coll: str, root: Optional[int], op: Optional[str],
              geom: Optional[Tuple], algorithm: Optional[str],
              counts: Optional[Tuple]) -> Tuple:
    return (seq, coll, root, op, geom, algorithm, counts)


def _render(sig: Tuple) -> str:
    seq, coll, root, op, geom, algorithm, counts = sig
    bits = [f"#{seq} {coll}"]
    if root is not None:
        bits.append(f"root={root}")
    if op is not None:
        bits.append(f"op={op}")
    if geom is not None:
        bits.append(f"geom={geom}")
    if algorithm is not None:
        bits.append(f"algorithm={algorithm}")
    if counts is not None:
        bits.append(f"counts={list(counts)}")
    return " ".join(bits)


def check(comm, coll: str, root: Optional[int] = None, op: Any = None,
          payload: Any = None, algorithm: Optional[str] = None,
          counts: Optional[Tuple] = None) -> None:
    """The collective-entry hook (size>1, verifier on): exchange this
    rank's signature around the ring and compare everyone's."""
    v = comm._verify
    seq = v.next_seq()
    opname = getattr(op, "name", None) if op is not None else None
    sig = signature(seq, coll, root, opname, geom_of(coll, payload),
                    algorithm, counts)
    site = user_site()
    p, r = comm.size, comm.rank
    entries = {r: (r, sig, site)}
    cur = entries[r]
    for _ in range(p - 1):
        cur = comm._sendrecv_internal(cur, (r + 1) % p, (r - 1) % p,
                                      TAG_VERIFY)
        entries[cur[0]] = cur
    ranks = sorted(entries)
    base_rank = ranks[0]
    _, base_sig, base_site = entries[base_rank]
    for q in ranks[1:]:
        _, q_sig, q_site = entries[q]
        if _differs(base_sig, q_sig):
            _mpit.count(verify_mismatches=1)
            msg = (f"collective mismatch on comm ctx={comm._ctx!r}:\n"
                   f"  rank {base_rank}: {_render(base_sig)} at {base_site}\n"
                   f"  rank {q}: {_render(q_sig)} at {q_site}")
            report_add(msg)
            raise CollectiveMismatchError(
                msg, ranks=(base_rank, q), signatures=(base_sig, q_sig),
                sites=(base_site, q_site))


def _differs(a: Tuple, b: Tuple) -> bool:
    # geometry (index 4) is only compared when BOTH ranks computed one:
    # a root-only payload (bcast) legitimately publishes None elsewhere
    for i in range(len(a)):
        if i == 4 and (a[i] is None or b[i] is None):
            continue
        if a[i] != b[i]:
            return True
    return False
