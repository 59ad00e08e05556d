"""Static MPI lint v2 (MUST / MPI-Checker style), grounded on a dataflow
engine instead of literal pattern-matching.

v1 matched the literal ``if c.rank == 0:`` shape and nothing
else.  v2 runs every program through :mod:`mpi_tpu_torch.verify.dataflow`
(guard chains + constant/rank propagation + a one-level call graph) and
:mod:`mpi_tpu_torch.verify.commgraph` (per-model-rank schedules + match
rules), so ``r = c.rank; if r == 0:``, ``peer = (c.rank + 1) % c.size``
and rank-guarded helper functions resolve exactly.  Undecidable facts
never fire a rule — every finding is still something a reader can
confirm by reading the flagged lines.  Suppress a deliberate one with
``# mpilint: ok`` on the flagged line or the line above.

The rules:

* **MPL001 — collective schedule divergence**: under the resolved rank
  conditions, some rank reaches a collective on ``c`` that other ranks
  never post (or posts a different one at the same position) — the
  divergent-order hang the runtime matcher catches dynamically.
* **MPL002 — send-send cycle**: two ranks whose first operation toward
  each other is a blocking send, both later receiving — legal under
  this library's buffered sends, but a deadlock under MPI's
  synchronous/rendezvous sends and any bounded-buffer transport; use
  ``sendrecv``.
* **MPL003 — count truncation**: a matched send/recv pair whose receive
  count is smaller than the send count — the receive silently
  truncates.
* **MPL004 — revoked comm without an error handler**: a p2p/collective
  call on a comm after ``c.revoke()`` appears, with no
  ``set_errhandler`` on it and outside any ``try``: every post-revoke
  call raises RevokedError, so unhandled it just moves the crash.
* **MPL005 — unwaited nonblocking request**: an ``isend/irecv/i*``
  request that reaches a function exit without ``wait()``/``test()``
  along at least one CFG path (branch joins are may-unions, so a
  request waited on only one side of an ``if`` still fires).
* **MPL006 — buffer reuse under a live request**: a write into a
  buffer while a nonblocking operation on it may still be in flight.
* **MPL007 — unmatchable tag pair**: a send and an exact-tag receive on
  the same channel whose tags can never match each other.
* **MPL008 — rank-dependent collective loop**: a collective inside a
  loop whose trip count depends on the rank — ranks execute different
  numbers of collectives.
* **MPL009 — racy ANY_SOURCE receive**: a wildcard receive with two or
  more eligible same-tag senders; the match order is nondeterministic
  (the runtime wildcard-race detector observes the same race via
  vector clocks — see ``mpi_tpu_torch.verify.vclock``).

``lint_source``/``lint_paths`` return :class:`Finding` lists; the CLI is
``python -m mpi_tpu_torch.tools.mpilint`` (``--format json``,
``--baseline``).

The port's own copy of ``mpi_tpu/verify/lint.py`` (:1-285), pure ``ast``
code with its rules unchanged.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from . import commgraph, dataflow

COLLECTIVES = dataflow.COLLECTIVES
_P2P_OR_COLL = COLLECTIVES | frozenset({
    "send", "recv", "sendrecv", "isend", "irecv", "probe", "iprobe",
    "shift", "exchange", "split", "dup",
})


class Finding(NamedTuple):
    file: str
    line: int
    code: str
    msg: str

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.code} {self.msg}"


def _method_call(node: ast.AST) -> Optional[Tuple[str, str, ast.Call]]:
    """(receiver-name, method, call) for ``name.method(...)`` nodes."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)):
        return node.func.value.id, node.func.attr, node
    return None


def _rank_eq_literal(test: ast.AST) -> Optional[Tuple[str, int]]:
    """(name, K) for a test of the exact form ``name.rank == K``.

    This was the ONLY guard shape v1 resolved; it is kept as the legacy
    reference predicate so tests can demonstrate v1-blind/v2-caught on
    the symbolic corpus variants."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)):
        return None
    sides = [test.left, test.comparators[0]]
    name = lit = None
    for s in sides:
        if (isinstance(s, ast.Attribute) and s.attr == "rank"
                and isinstance(s.value, ast.Name)):
            name = s.value.id
        elif isinstance(s, ast.Constant) and isinstance(s.value, int):
            lit = s.value
    return (name, lit) if name is not None and lit is not None else None


def _calls_in(nodes: Sequence[ast.AST], *, into_defs: bool = False):
    """Every Call in the given statement subtrees, skipping nested
    function/class bodies unless asked (their execution time is
    unrelated to the enclosing branch)."""
    stack = list(nodes)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)) and not into_defs:
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _suppressed(src: str) -> set:
    out = set()
    for i, line in enumerate(src.splitlines(), 1):
        if "mpilint: ok" in line:
            out.add(i)
            out.add(i + 1)
    return out


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    try:
        tree = ast.parse(src, filename)
    except SyntaxError as e:
        return [Finding(filename, e.lineno or 0, "MPL000",
                        f"syntax error: {e.msg}")]
    findings: List[Finding] = []

    # engine-grounded rules: MPL001/002/003/007/009 off the match graph,
    # MPL008 off the loop evidence the op walk collects
    roots, rank_loops = dataflow.collect_roots(tree)
    for cg in commgraph.analyze(roots):
        findings.append(Finding(filename, cg.line, cg.code, cg.msg))
    for rl in rank_loops:
        findings.append(Finding(
            filename, rl.line, "MPL008",
            f"collective {rl.comm}.{rl.name}() inside a loop (line "
            f"{rl.loop_line}) whose trip count depends on {rl.comm}.rank: "
            f"ranks execute different numbers of collectives and the "
            f"schedule diverges"))

    # per-function local rules
    findings += _check_revoked_unhandled(tree, filename)
    findings += _check_request_flow(tree, filename)

    sup = _suppressed(src)
    seen = set()
    out = []
    for f in sorted((f for f in findings if f.line not in sup),
                    key=lambda f: (f.line, f.code)):
        key = (f.line, f.code)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


# -- MPL004 ------------------------------------------------------------------

def _alias_map(tree: ast.Module) -> Dict[str, str]:
    """Simple name-to-name bindings (``c2 = comm``), so a comm revoked
    under an alias still pairs with calls through the original name."""
    out: Dict[str, str] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and isinstance(n.value, ast.Name):
            out[n.targets[0].id] = n.value.id
    return out


def _canon(name: str, aliases: Dict[str, str]) -> str:
    seen = set()
    while name in aliases and name not in seen:
        seen.add(name)
        name = aliases[name]
    return name


def _check_revoked_unhandled(tree, filename) -> List[Finding]:
    aliases = _alias_map(tree)
    revoked: Dict[str, int] = {}
    handled: set = set()
    in_try: set = set()

    def mark_try(node, inside):
        inside = inside or isinstance(node, ast.Try)
        if inside:
            in_try.add(id(node))
        for c in ast.iter_child_nodes(node):
            mark_try(c, inside)

    mark_try(tree, False)
    for call in _calls_in([tree], into_defs=True):
        mc = _method_call(call)
        if mc is None:
            continue
        name, meth, _ = mc
        name = _canon(name, aliases)
        if meth == "revoke":
            revoked.setdefault(name, call.lineno)
        elif meth == "set_errhandler":
            handled.add(name)
    findings = []
    if not revoked:
        return findings
    flagged = set()
    for call in _calls_in([tree], into_defs=True):
        mc = _method_call(call)
        if mc is None:
            continue
        name, meth, _ = mc
        name = _canon(name, aliases)
        if (name in revoked and name not in handled and name not in flagged
                and meth in _P2P_OR_COLL and call.lineno > revoked[name]
                and id(call) not in in_try):
            flagged.add(name)
            findings.append(Finding(
                filename, call.lineno, "MPL004",
                f"{name}.{meth}() after {name}.revoke() (line "
                f"{revoked[name]}) with no error handler and outside "
                f"try: every operation on a revoked comm raises "
                f"RevokedError — install set_errhandler or shrink() "
                f"first"))
    return findings


# -- MPL005 / MPL006 ---------------------------------------------------------

def _check_request_flow(tree, filename) -> List[Finding]:
    findings = []
    module_stmts = [s for s in tree.body
                    if not isinstance(s, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef))]
    bodies = [module_stmts] + [fn.body for fn in dataflow.all_functions(tree)]
    for body in bodies:
        for issue in dataflow.request_flow(body):
            if issue.code == "MPL005":
                findings.append(Finding(
                    filename, issue.line, "MPL005",
                    f"nonblocking {issue.op_name}() request is never "
                    f"completed along at least one path to exit (no "
                    f"wait/test reaches it): the operation may never "
                    f"finish and its resources leak"))
            else:
                findings.append(Finding(
                    filename, issue.line, "MPL006",
                    f"buffer '{issue.buf}' is written while the "
                    f"{issue.op_name}() request from line {issue.op_line} "
                    f"may still be live: complete the request before "
                    f"reusing its buffer"))
    return findings


# -- entry points ------------------------------------------------------------

def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return lint_source(f.read(), path)


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        findings += lint_file(os.path.join(root, fn))
        elif p.endswith(".py"):
            findings += lint_file(p)
    return findings
