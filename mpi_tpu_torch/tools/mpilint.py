"""Static MPI linter CLI (``verify/lint.py`` — MPI-Checker style, v2:
dataflow + communication-graph engine) — the port's own copy of
``tools/mpilint.py`` (:1-148): the same rules, output, ``--format json``,
``--baseline`` and stale-entry warnings.

Flags, over any .py files or directories:

* MPL001 — divergent collective schedule across ranks (literal OR
  symbolic rank guards: ``r = comm.rank``, rank-conditional helpers);
* MPL002 — blocking send-send cycles between resolvable rank pairs
  (deadlock under synchronous sends);
* MPL003 — recv-count < send-count truncation in a matched pair;
* MPL004 — operations on a revoked comm (incl. aliases) without an
  error handler;
* MPL005 — nonblocking request never completed along some path;
* MPL006 — buffer written while its nonblocking request may be live;
* MPL007 — tag mismatch: a send whose matched receiver can never
  accept its tag;
* MPL008 — collective inside a loop whose trip count depends on rank;
* MPL009 — ANY_SOURCE recv with 2+ concurrent eligible senders
  (nondeterministic matching — the static half of the runtime
  wildcard-race detector).

Suppress a deliberate pattern with ``# mpilint: ok`` on (or right
above) the flagged line.  Exit code 1 iff findings remain (after
baseline subtraction, when --baseline is given).

``--format json`` emits a machine-readable report; ``--baseline
FILE.json`` loads a committed allowance (grouped by (file, code) with
a count and a rationale) and fails only on findings OUTSIDE it — the
CI workflow for deliberately-seeded test scenarios: new findings fail
the gate, fixed findings show up as stale-entry warnings prompting a
baseline shrink.

Usage::

    python -m mpi_tpu_torch.tools.mpilint mpi_tpu_torch/examples/
    python -m mpi_tpu_torch.tools.mpilint --select MPL001,MPL002 myprog.py
    python -m mpi_tpu_torch.tools.mpilint --format json --baseline FILE.json \
        PATHS
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..verify.lint import lint_paths


def _norm(path: str) -> str:
    """Stable baseline key: repo-relative, forward slashes."""
    return os.path.relpath(path).replace(os.sep, "/")


def load_baseline(path: str) -> dict:
    """{(file, code): {"count": int, "why": str}} from the committed
    allowance file."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out = {}
    for e in data.get("entries", []):
        out[(e["file"], e["code"])] = {
            "count": int(e.get("count", 0)),
            "why": e.get("why", ""),
        }
    return out


def apply_baseline(findings, baseline):
    """(new_findings, stale_keys): findings not covered by the
    allowance, and allowance entries no finding used at all (candidates
    for deletion).  Per (file, code) group, up to ``count`` findings
    are absorbed; the overflow — a NEW instance of a baselined pattern
    — still fails."""
    groups = {}
    for f in findings:
        groups.setdefault((_norm(f.file), f.code), []).append(f)
    new = []
    for key, fs in sorted(groups.items()):
        allowed = baseline.get(key, {"count": 0})["count"]
        if len(fs) > allowed:
            new += fs[allowed:]
    used = {k for k in groups if k in baseline}
    stale = sorted(set(baseline) - used)
    new.sort(key=lambda f: (f.file, f.line, f.code))
    return new, stale


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", help=".py files or directories")
    ap.add_argument("--select", default=None,
                    help="comma-separated codes to report (default: all)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="output format (default: text)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="committed allowance JSON: fail only on "
                         "findings outside it")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the OK line")
    args = ap.parse_args(argv)
    findings = lint_paths(args.paths)
    if args.select:
        keep = {c.strip() for c in args.select.split(",")}
        findings = [f for f in findings if f.code in keep]

    stale = []
    gate = findings
    if args.baseline:
        baseline = load_baseline(args.baseline)
        gate, stale = apply_baseline(findings, baseline)

    if args.format == "json":
        doc = {
            "findings": [
                {"file": _norm(f.file), "line": f.line, "code": f.code,
                 "msg": f.msg} for f in findings],
            "new": [
                {"file": _norm(f.file), "line": f.line, "code": f.code,
                 "msg": f.msg} for f in gate],
            "stale_baseline": [{"file": k[0], "code": k[1]} for k in stale],
            "ok": not gate,
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 1 if gate else 0

    for f in gate:
        print(f.render())
    for k in stale:
        print(f"mpilint: warning: stale baseline entry {k[0]} {k[1]} "
              f"(no such finding remains — shrink the baseline)")
    if gate:
        what = "new finding(s)" if args.baseline else "finding(s)"
        print(f"mpilint: {len(gate)} {what}")
        return 1
    if not args.quiet:
        n = len(findings)
        base = f" ({n} baselined)" if args.baseline and n else ""
        print(f"mpilint: OK{base}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
