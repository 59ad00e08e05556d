"""tracecat — merge per-rank flight-recorder traces onto ONE timeline —
the port's own copy of ``tools/tracecat.py`` (:1-293), unchanged apart
from this paragraph and the usage lines.  The per-rank documents keep the
reference's ``mpi_tpu`` metadata key, so either package's traces merge.

Each rank of a traced run (``MPI_TPU_TRACE=1`` / launcher
``--trace-dir``) exports its own Chrome-trace JSON
(``trace.r<rank>.<pid>.json``, ``telemetry/recorder.py``).  This
tool merges them so a 3-rank run renders as one Perfetto timeline —
rank per process row, thread per track — with **cross-rank clock
alignment** in two layers:

1. **Wall anchor** (coarse): every trace carries a ``(time_ns,
   perf_counter_ns)`` anchor pair taken at enable; export already maps
   monotonic timestamps onto the wall clock, which is shared on a
   single host up to the anchor-read jitter.
2. **Message matching** (fine, ``--no-align`` disables): the sequenced
   socket frames are recorded on BOTH ends (``frame send`` carries
   (dest, seq), ``frame recv`` carries (src, seq) — the resilient
   link layer's per-destination sequence numbers make the match
   exact).  For each rank pair, every matched frame gives a one-way
   bound on the clock offset (a frame cannot arrive before it was
   sent); the two directions bracket the offset and the midpoint is
   the classic round-trip estimate — the same offset the hello/
   heartbeat round-trips would give, computed post-hoc from events
   that already exist instead of a wire change.  Offsets are solved
   relative to the lowest rank across the connectivity graph and each
   rank's events are shifted by ITS constant — per-rank event order
   (monotonicity) is preserved by construction.

Usage::

    python -m mpi_tpu_torch.tools.tracecat TRACE_DIR -o merged.json
    python -m mpi_tpu_torch.tools.tracecat a.json b.json c.json -o merged.json
    python -m mpi_tpu_torch.tools.tracecat TRACE_DIR --report        # offsets only
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

MERGED_DEFAULT = "merged.json"


def load_traces(paths: List[str]) -> List[dict]:
    """Expand directories to their per-rank trace files and parse.
    A merged output sitting in the same directory is skipped (it has
    no per-rank ``mpi_tpu`` metadata — and re-merging a merge would
    double events)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "trace.r*.json"))))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no trace files under {paths!r}")
    docs = []
    for f in files:
        with open(f) as fh:
            doc = json.load(fh)
        if "pid" not in doc.get("mpi_tpu", {}):
            # not a per-rank flight-recorder export: a merged output's
            # own mpi_tpu block carries merge metadata, never a pid —
            # re-merging a merge would double events
            continue
        doc["_path"] = f
        docs.append(doc)
    if not docs:
        raise ValueError(f"no flight-recorder traces among {files!r}")
    return docs


def _rank_of(doc: dict):
    r = doc["mpi_tpu"].get("rank")
    return doc["mpi_tpu"]["pid"] if r is None else r


def _frame_endpoints(doc: dict) -> Tuple[Dict, Dict]:
    """(sends, recvs) of this rank's frame events, keyed by the
    globally unique (src_rank, dst_rank, seq) triple."""
    me = _rank_of(doc)
    sends: Dict[Tuple, float] = {}
    recvs: Dict[Tuple, float] = {}
    for e in doc["traceEvents"]:
        if e.get("cat") != "frame":
            continue
        a = e.get("args") or {}
        if e.get("name") == "send" and "seq" in a:
            sends[(me, a.get("dest"), a["seq"])] = e["ts"]
        elif e.get("name") == "recv" and "seq" in a:
            recvs[(a.get("src"), me, a["seq"])] = e["ts"]
    return sends, recvs


def estimate_offsets(docs: List[dict]) -> Dict:
    """Per-rank clock offsets (microseconds, added to that rank's
    timestamps) from matched frame send/recv pairs, solved relative to
    the lowest rank.  Ranks with no usable message path to the
    reference keep offset 0 (the wall anchor already landed them
    close)."""
    ranks = [_rank_of(d) for d in docs]
    if len(set(ranks)) != len(ranks):
        # two process generations share a rank id (serve workers and
        # relaunched worlds export into one dir, pid-suffixed): their
        # clocks AND seq spaces alias, so message matching would pair
        # frames across unrelated runs — keep the wall anchors only
        sys.stderr.write("tracecat: duplicate rank ids across traces; "
                         "skipping message-matching alignment\n")
        return {r: 0.0 for r in ranks}
    ends = {_rank_of(d): _frame_endpoints(d) for d in docs}
    # pairwise bounds: d[a][b] = off_b - off_a bracketed by [lo, hi]
    bounds: Dict[Tuple, List[Optional[float]]] = {}
    for a in ranks:
        sends_a, _ = ends[a]
        for (src, dst, seq), ts_send in sends_a.items():
            if dst not in ends:
                continue
            ts_recv = ends[dst][1].get((src, dst, seq))
            if ts_recv is None:
                continue
            # recv_ts + off_dst >= send_ts + off_src
            #   => (off_dst - off_src) >= send_ts - recv_ts
            key = (min(a, dst), max(a, dst))
            lo_hi = bounds.setdefault(key, [None, None])
            gap = ts_send - ts_recv
            if a == key[0]:  # bound on off_hi - off_lo from lo->hi
                if lo_hi[0] is None or gap > lo_hi[0]:
                    lo_hi[0] = gap
            else:            # reverse direction bounds it from above
                if lo_hi[1] is None or -gap < lo_hi[1]:
                    lo_hi[1] = -gap
    pair_est: Dict[Tuple, float] = {}
    for (a, b), (lo, hi) in bounds.items():
        if lo is not None and hi is not None:
            pair_est[(a, b)] = (lo + hi) / 2.0
        elif lo is not None:
            pair_est[(a, b)] = lo
        elif hi is not None:
            pair_est[(a, b)] = hi
    # BFS the pair graph from the reference rank (midpoint seed) ...
    offsets: Dict = {r: 0.0 for r in ranks}
    if pair_est:
        ref = min(ranks)
        seen = {ref}
        frontier = [ref]
        while frontier:
            cur = frontier.pop()
            for (a, b), d in pair_est.items():
                for nxt, sign, anchor in ((b, 1.0, a), (a, -1.0, b)):
                    if anchor == cur and nxt not in seen:
                        offsets[nxt] = offsets[cur] + sign * d
                        seen.add(nxt)
                        frontier.append(nxt)
        # ... then alternating projection onto the hard bounds: pair
        # midpoints need not be consistent around a triangle (loaded-
        # box delivery latency is asymmetric), but the TRUE offsets
        # satisfy every [lo, hi] bracket simultaneously (each bound is
        # a matched frame's arithmetic), so the feasible set is a
        # nonempty convex polytope and projecting per-pair converges
        # into it — after which no aligned frame arrives before it was
        # sent.
        for _ in range(200):
            worst = 0.0
            for (a, b), (lo, hi) in bounds.items():
                d = offsets[b] - offsets[a]
                adj = 0.0
                if lo is not None and d < lo:
                    adj = lo - d
                elif hi is not None and d > hi:
                    adj = hi - d
                if adj:
                    offsets[b] += adj / 2.0
                    offsets[a] -= adj / 2.0
                    worst = max(worst, abs(adj))
            if worst < 1e-3:  # 1ns in us units
                break
        base = offsets[ref]
        for r in offsets:
            offsets[r] -= base  # the reference rank stays unshifted
    return offsets


def negative_latency_frames(docs: List[dict],
                            offsets: Dict) -> int:
    """Matched frames whose aligned recv still precedes their send —
    the alignment residual the report prints (0 is ideal; a handful at
    sub-ms scale is scheduler jitter on an oversubscribed box)."""
    ends = {_rank_of(d): _frame_endpoints(d) for d in docs}
    bad = 0
    for a, (sends, _) in ends.items():
        for (src, dst, seq), ts_send in sends.items():
            peer = ends.get(dst)
            if peer is None:
                continue
            ts_recv = peer[1].get((src, dst, seq))
            if ts_recv is None:
                continue
            if ts_recv + offsets.get(dst, 0.0) \
                    < ts_send + offsets.get(a, 0.0):
                bad += 1
    return bad


def merge(docs: List[dict], align: bool = True) -> dict:
    """One merged Chrome-trace document: per-rank offsets applied,
    events sorted by aligned timestamp, per-rank metadata preserved
    under ``mpi_tpu.ranks``."""
    offsets = estimate_offsets(docs) if align else {}
    events: List[dict] = []
    for doc in docs:
        off = offsets.get(_rank_of(doc), 0.0)
        for e in doc["traceEvents"]:
            if "ts" in e:
                e = dict(e)
                e["ts"] = e["ts"] + off
            events.append(e)
    events.sort(key=lambda e: e.get("ts", -1.0))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "mpi_tpu": {
            "merged_from": [d["_path"] for d in docs],
            "aligned": bool(align),
            "offsets_us": {str(r): round(o, 3)
                           for r, o in offsets.items()},
            "negative_latency_frames": negative_latency_frames(
                docs, offsets),
            "ranks": {str(_rank_of(d)): d["mpi_tpu"] for d in docs},
        },
    }


def merge_paths(paths: List[str], out: str, align: bool = True) -> dict:
    """Library entry (benchmarks/chaos.py, tests): load + merge +
    write; returns the merged document."""
    doc = merge(load_traces(paths), align=align)
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+",
                    help="trace dir(s) and/or per-rank trace files")
    ap.add_argument("-o", "--out", default=None,
                    help=f"merged output (default: <first dir>/"
                         f"{MERGED_DEFAULT})")
    ap.add_argument("--no-align", action="store_true",
                    help="skip message-matching offset refinement "
                         "(keep the wall-clock anchors only)")
    ap.add_argument("--report", action="store_true",
                    help="print the alignment report, write nothing")
    args = ap.parse_args(argv)
    docs = load_traces(args.paths)
    if args.report:
        offsets = estimate_offsets(docs)
        print(json.dumps({
            "traces": [d["_path"] for d in docs],
            "offsets_us": {str(r): round(o, 3)
                           for r, o in offsets.items()},
            "negative_latency_frames": negative_latency_frames(
                docs, offsets),
        }, indent=2))
        return 0
    out = args.out
    if out is None:
        first = args.paths[0]
        base = first if os.path.isdir(first) else os.path.dirname(first)
        out = os.path.join(base, MERGED_DEFAULT)
    doc = merge(docs, align=not args.no_align)
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out)
    meta = doc["mpi_tpu"]
    print(f"tracecat: merged {len(meta['ranks'])} rank trace(s), "
          f"{len(doc['traceEvents'])} events -> {out}")
    if meta["aligned"]:
        print(f"tracecat: offsets_us={meta['offsets_us']} "
              f"negative_latency_frames="
              f"{meta['negative_latency_frames']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
