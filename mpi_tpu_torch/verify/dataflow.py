"""Dataflow engine under mpilint v2.

The v1 linter pattern-matched literal ``if c.rank == 0:`` tests;
it was blind the moment a rank landed in a variable, a helper function,
or a loop bound.  This module is the small analysis engine the v2 rules
are grounded on:

* **Per-function walk over ``ast``** with an explicit guard stack: every
  MPI operation (:class:`Op`) records the chain of branch conditions it
  sits under, each with a snapshot of the variable environment at that
  point.  Early ``return``/``raise`` in a branch contributes the
  *negated* test to the statements after the ``if`` (the leader-pattern
  ``if c.rank != 0: return`` shape).
* **Constant / rank propagation**: assignments bind names to
  :class:`Sym` closures (expression + environment snapshot); evaluation
  (:func:`eval_expr`) substitutes a concrete ``(rank, size)`` pair and
  constant-folds, so ``r = comm.rank; if r == 0:`` or ``left = (comm.rank
  - 1) % comm.size`` resolve exactly.  Anything the folder cannot decide
  evaluates to ``None`` — callers treat that as *undecidable* and stay
  silent (the linter's findings must survive review, so unknown never
  fires a rule).
* **One-level call graph**: a call to a module-level function with a
  communicator argument splices the callee's operations into the caller
  (parameters bound to the caller's argument expressions), so
  ``def leader_only(c): if c.rank == 0: c.bcast(...)`` resolves at its
  call sites.  One level only — calls inside a spliced callee are not
  resolved further.
* **Request flow** (:func:`request_flow`): a may-analysis over the
  statement CFG tracking nonblocking requests from creation to a
  completion call.  Branch joins union the maybe-live sets, so a request
  waited on only one side of an ``if`` is still live "along some CFG
  path" (MPL005); writes to a live request's buffer surface as MPL006
  evidence.  Any escape (stored, passed, returned, appended) discharges
  the request — the analysis only flags the shapes it can prove.

The whole-tree send/recv/collective matching on top of these facts lives
in :mod:`mpi_tpu_torch.verify.commgraph`; the rule wiring and the public
``lint_source`` API stay in :mod:`mpi_tpu_torch.verify.lint`.

The port's own copy of ``mpi_tpu/verify/dataflow.py`` (:1-831), pure ``ast``
code with its rules unchanged.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

# Evaluation depth cap: Sym chains are acyclic by construction (each
# snapshot only references older bindings) but splices and long copy
# chains can nest; past this depth we give up and return "undecidable".
_MAX_DEPTH = 32

# Names that spell the wildcards in any of the supported dialects.
_WILDCARD_NAMES = frozenset({
    "ANY_SOURCE", "MPI_ANY_SOURCE", "ANY_TAG", "MPI_ANY_TAG",
})

# Nonblocking request constructors (methods on a comm, or MPI_* call
# forms).  Persistent *_init requests are deliberately excluded from the
# request-flow rules: their lifecycle is start/wait cycles ended by
# free(), not a single wait.
NONBLOCKING_METHODS = frozenset({
    "isend", "irecv", "isendrecv", "isendrecv_replace",
    "ibarrier", "ibcast", "iallreduce", "ireduce", "igather",
    "iallgather", "iscatter", "ialltoall", "ireduce_scatter",
    "iscan", "iexscan",
})
NONBLOCKING_FUNCS = frozenset({"MPI_Isend", "MPI_Irecv"})

# Calls that complete (or otherwise account for) a request.
_COMPLETION_METHODS = frozenset({"wait", "test", "free", "cancel"})
_COMPLETION_FUNCS = frozenset({
    "MPI_Wait", "MPI_Test", "MPI_Waitall", "MPI_Waitany", "MPI_Waitsome",
    "MPI_Testall", "MPI_Testany",
})


class Sym(NamedTuple):
    """A deferred expression: AST node + the environment it closed over."""
    node: ast.AST
    env: Dict[str, "Sym"]


class Guard(NamedTuple):
    """One branch condition an operation sits under."""
    test: ast.AST
    env: Dict[str, Sym]
    polarity: bool  # True: taken when test is truthy


class Op(NamedTuple):
    """One MPI operation with its resolved context."""
    comm: str                 # canonical communicator key (source text)
    kind: str                 # 'coll' | 'send' | 'recv' | 'nb'
    name: str                 # method / function name
    line: int
    guards: Tuple[Guard, ...]
    env: Dict[str, Sym]       # environment at the call
    peer: Optional[ast.AST]   # dest (sends) / source (recvs)
    tag: Optional[ast.AST]    # None: the API default
    count: Optional[ast.AST]
    in_rank_loop: bool        # enclosing loop trip count is rank-dependent


class RankLoopColl(NamedTuple):
    """MPL008 evidence: a collective inside a rank-dependent loop."""
    comm: str
    name: str
    line: int
    loop_line: int


class RootOps(NamedTuple):
    """Operations of one analysis root (module body or uncalled function,
    with one level of callee splicing)."""
    name: str
    ops: List[Op]


class ReqIssue(NamedTuple):
    """MPL005/006 evidence from the request-flow analysis."""
    code: str       # 'MPL005' | 'MPL006'
    line: int       # report line (creation for 005, the write for 006)
    op_line: int    # request creation line
    op_name: str
    buf: Optional[str]


# The collective vocabulary (shared with lint.py via import there).
COLLECTIVES = frozenset({
    "bcast", "reduce", "allreduce", "allgather", "allgatherv", "alltoall",
    "alltoallv", "barrier", "scan", "exscan", "reduce_scatter", "scatter",
    "scatterv", "gather", "gatherv", "maxloc", "minloc",
})


# -- expression evaluation ---------------------------------------------------

def resolve_comm(expr: ast.AST, env: Dict[str, Sym],
                 depth: int = 0) -> Optional[str]:
    """Canonical communicator key for a receiver expression: follow
    name-to-name bindings (so a spliced callee's parameter resolves to
    the caller's argument), then use the source text.  Returns None for
    expressions that cannot name a communicator."""
    if depth > _MAX_DEPTH:
        return None
    if isinstance(expr, ast.Name):
        bound = env.get(expr.id)
        if bound is not None and isinstance(bound.node, (ast.Name,
                                                         ast.Attribute)):
            return resolve_comm(bound.node, bound.env, depth + 1)
        return expr.id
    if isinstance(expr, ast.Attribute):
        try:
            return ast.unparse(expr)
        except Exception:  # pragma: no cover - malformed tree
            return None
    return None


def eval_expr(node: Optional[ast.AST], env: Dict[str, Sym],
              comm: Optional[str], rank: int, size: int,
              depth: int = 0) -> Optional[Any]:
    """Constant-fold ``node`` with ``<comm>.rank`` := rank and
    ``<comm>.size`` := size (``comm=None`` treats ANY receiver's
    rank/size that way — used for rank-dependence probes).  Returns an
    int/bool, or None when undecidable."""
    if node is None or depth > _MAX_DEPTH:
        return None
    if isinstance(node, ast.Constant):
        v = node.value
        return v if isinstance(v, (int, bool)) else None
    if isinstance(node, ast.Name):
        if node.id in _WILDCARD_NAMES:
            return -1
        bound = env.get(node.id)
        if bound is None:
            return None
        return eval_expr(bound.node, bound.env, comm, rank, size, depth + 1)
    if isinstance(node, ast.Attribute):
        if node.attr in _WILDCARD_NAMES:
            return -1
        if node.attr in ("rank", "world_rank", "size", "world_size"):
            base = resolve_comm(node.value, env)
            if base is None or (comm is not None and base != comm):
                return None
            return rank if node.attr in ("rank", "world_rank") else size
        return None
    if isinstance(node, ast.UnaryOp):
        v = eval_expr(node.operand, env, comm, rank, size, depth + 1)
        if v is None:
            return None
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return +v
        if isinstance(node.op, ast.Not):
            return not v
        return None
    if isinstance(node, ast.BinOp):
        a = eval_expr(node.left, env, comm, rank, size, depth + 1)
        b = eval_expr(node.right, env, comm, rank, size, depth + 1)
        if a is None or b is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.FloorDiv):
                return a // b
            if isinstance(node.op, ast.Mod):
                return a % b
            if isinstance(node.op, ast.Pow) and abs(b) < 32:
                return a ** b
        except (ZeroDivisionError, ValueError):
            return None
        return None
    if isinstance(node, ast.Compare):
        left = eval_expr(node.left, env, comm, rank, size, depth + 1)
        if left is None:
            return None
        for op, rhs in zip(node.ops, node.comparators):
            right = eval_expr(rhs, env, comm, rank, size, depth + 1)
            if right is None:
                return None
            if isinstance(op, ast.Eq):
                ok = left == right
            elif isinstance(op, ast.NotEq):
                ok = left != right
            elif isinstance(op, ast.Lt):
                ok = left < right
            elif isinstance(op, ast.LtE):
                ok = left <= right
            elif isinstance(op, ast.Gt):
                ok = left > right
            elif isinstance(op, ast.GtE):
                ok = left >= right
            else:
                return None
            if not ok:
                return False
            left = right
        return True
    if isinstance(node, ast.BoolOp):
        vals = [eval_expr(v, env, comm, rank, size, depth + 1)
                for v in node.values]
        if isinstance(node.op, ast.And):
            if any(v is False for v in vals):
                return False
            if any(v is None for v in vals):
                return None
            return True
        if any(v is True for v in vals):
            return True
        if any(v is None for v in vals):
            return None
        return False
    if isinstance(node, ast.IfExp):
        t = eval_expr(node.test, env, comm, rank, size, depth + 1)
        if t is None:
            return None
        pick = node.body if t else node.orelse
        return eval_expr(pick, env, comm, rank, size, depth + 1)
    return None


def mentions_rank(node: Optional[ast.AST], env: Dict[str, Sym],
                  depth: int = 0) -> bool:
    """Syntactic rank-dependence probe: does the expression reach a
    ``.rank`` attribute, directly or through bindings?"""
    if node is None or depth > _MAX_DEPTH:
        return False
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in ("rank", "world_rank"):
            return True
        if isinstance(n, ast.Name):
            bound = env.get(n.id)
            if bound is not None and mentions_rank(bound.node, bound.env,
                                                   depth + 1):
                return True
    return False


def rank_dependent(node: Optional[ast.AST], env: Dict[str, Sym]) -> bool:
    """True when the expression's value provably varies with the rank
    (evaluates to different values at different ranks), or mentions rank
    in a way the folder cannot resolve."""
    if node is None:
        return False
    vals = [eval_expr(node, env, None, r, 5) for r in range(4)]
    known = [v for v in vals if v is not None]
    if len(known) >= 2 and any(v != known[0] for v in known[1:]):
        return True
    if known and len(known) == len(vals):
        return False  # fully evaluated, identical at every rank
    return mentions_rank(node, env)


# -- call helpers ------------------------------------------------------------

def _attr_call(call: ast.Call) -> Optional[Tuple[ast.AST, str]]:
    if isinstance(call.func, ast.Attribute):
        return call.func.value, call.func.attr
    return None


def _arg(call: ast.Call, kw: str, pos: Optional[int]) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    if pos is not None and len(call.args) > pos:
        return call.args[pos]
    return None


# Method-call argument slots: (peer kw, peer pos, tag default handling).
# send(obj, dest, tag=0) / recv(source=ANY_SOURCE, tag=ANY_TAG).
_P2P_SLOTS = {
    "send": ("send", "dest", 1),
    "ssend": ("send", "dest", 1),
    "isend": ("send", "dest", 1),
    "recv": ("recv", "source", 0),
    "irecv": ("recv", "source", 0),
}
_FUNC_SLOTS = {
    "MPI_Send": ("send", "dest", 1),
    "MPI_Isend": ("send", "dest", 1),
    "MPI_Recv": ("recv", "source", 0),
    "MPI_Irecv": ("recv", "source", 0),
}


# -- the operation collector -------------------------------------------------

class _Loop(NamedTuple):
    line: int
    rank_dep: bool


class OpCollector:
    """Walk one root (module body or function) collecting :class:`Op`
    records with guard chains, plus MPL008 loop evidence.  ``funcs`` is
    the module's top-level function table for one-level splicing."""

    def __init__(self, funcs: Dict[str, ast.FunctionDef]) -> None:
        self.funcs = funcs
        self.ops: List[Op] = []
        self.rank_loops: List[RankLoopColl] = []

    # .. statement walk ......................................................

    def walk_root(self, body: Sequence[ast.stmt]) -> None:
        self._walk_block(body, {}, [], [], splice=True)

    def _walk_block(self, body: Sequence[ast.stmt], env: Dict[str, Sym],
                    guards: List[Guard], loops: List[_Loop],
                    splice: bool) -> bool:
        """Walk a statement sequence; returns True when the block
        terminates (return/raise on every path through its tail)."""
        extra: List[Guard] = []
        for stmt in body:
            g = guards + extra
            if isinstance(stmt, (ast.Return, ast.Raise)):
                self._scan_exprs(stmt, env, g, loops, splice)
                return True
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs execute on their own schedule
            if isinstance(stmt, ast.If):
                self._scan_exprs(stmt.test, env, g, loops, splice)
                genv = dict(env)
                t_end = self._walk_block(
                    stmt.body, dict(env),
                    g + [Guard(stmt.test, genv, True)], loops, splice)
                f_end = self._walk_block(
                    stmt.orelse, dict(env),
                    g + [Guard(stmt.test, genv, False)], loops, splice)
                if t_end and f_end and stmt.orelse:
                    return True
                if t_end and not f_end:
                    extra = extra + [Guard(stmt.test, genv, False)]
                elif f_end and not t_end:
                    extra = extra + [Guard(stmt.test, genv, True)]
                # branch assignments are not merged back (env stays the
                # pre-branch snapshot): a post-branch read of a
                # branch-assigned name evaluates as undecidable, which
                # is the conservative direction
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                trip = stmt.iter
                if (isinstance(trip, ast.Call)
                        and isinstance(trip.func, ast.Name)
                        and trip.func.id == "range"):
                    dep = any(rank_dependent(a, env) for a in trip.args)
                else:
                    dep = rank_dependent(trip, env)
                self._scan_exprs(stmt.iter, env, g, loops, splice)
                lenv = dict(env)
                for t in ast.walk(stmt.target):
                    if isinstance(t, ast.Name):
                        lenv.pop(t.id, None)  # loop var: unknown value
                self._walk_block(stmt.body, lenv, list(g),
                                 loops + [_Loop(stmt.lineno, dep)], splice)
                self._walk_block(stmt.orelse, dict(env), list(g), loops,
                                 splice)
                continue
            if isinstance(stmt, ast.While):
                dep = rank_dependent(stmt.test, env)
                self._scan_exprs(stmt.test, env, g, loops, splice)
                self._walk_block(stmt.body, dict(env), list(g),
                                 loops + [_Loop(stmt.lineno, dep)], splice)
                self._walk_block(stmt.orelse, dict(env), list(g), loops,
                                 splice)
                continue
            if isinstance(stmt, ast.Try):
                ended = self._walk_block(stmt.body, dict(env), list(g),
                                         loops, splice)
                for h in stmt.handlers:
                    self._walk_block(h.body, dict(env), list(g), loops,
                                     splice)
                self._walk_block(stmt.orelse, dict(env), list(g), loops,
                                 splice)
                self._walk_block(stmt.finalbody, dict(env), list(g), loops,
                                 splice)
                del ended  # a try's reachability is not modeled
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._scan_exprs(item.context_expr, env, g, loops,
                                     splice)
                self._walk_block(stmt.body, env, list(g), loops, splice)
                continue
            # simple statement: collect ops from its expressions, then
            # update the environment for assignments
            self._scan_exprs(stmt, env, g, loops, splice)
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                env[stmt.targets[0].id] = Sym(stmt.value, dict(env))
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and stmt.value is not None:
                env[stmt.target.id] = Sym(stmt.value, dict(env))
            elif isinstance(stmt, ast.AugAssign) \
                    and isinstance(stmt.target, ast.Name):
                env.pop(stmt.target.id, None)  # x += ...: give up on x
        return False

    # .. expression scan (op extraction + one-level splicing) ................

    def _scan_exprs(self, node: ast.AST, env: Dict[str, Sym],
                    guards: List[Guard], loops: List[_Loop],
                    splice: bool) -> None:
        stack: List[ast.AST] = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(n, ast.Call):
                self._handle_call(n, env, guards, loops, splice)
            stack.extend(ast.iter_child_nodes(n))

    def _handle_call(self, call: ast.Call, env: Dict[str, Sym],
                     guards: List[Guard], loops: List[_Loop],
                     splice: bool) -> None:
        mc = _attr_call(call)
        if mc is not None:
            recv_expr, meth = mc
            comm = resolve_comm(recv_expr, env)
            if comm is None:
                return
            in_rank_loop = any(lp.rank_dep for lp in loops)
            if meth in COLLECTIVES:
                if in_rank_loop:
                    dep_line = next(lp.line for lp in loops if lp.rank_dep)
                    self.rank_loops.append(
                        RankLoopColl(comm, meth, call.lineno, dep_line))
                self.ops.append(Op(
                    comm, "coll", meth, call.lineno, tuple(guards),
                    dict(env), None, None, None, in_rank_loop))
            elif meth in _P2P_SLOTS:
                kind, peer_kw, peer_pos = _P2P_SLOTS[meth]
                self.ops.append(Op(
                    comm, "nb" if meth.startswith("i") else kind,
                    meth, call.lineno, tuple(guards), dict(env),
                    _arg(call, peer_kw, peer_pos), _arg(call, "tag", None),
                    _arg(call, "count", None), in_rank_loop))
            return
        if isinstance(call.func, ast.Name):
            fname = call.func.id
            if fname in _FUNC_SLOTS:
                kind, peer_kw, peer_pos = _FUNC_SLOTS[fname]
                comm_arg = _arg(call, "comm", None)
                comm = (resolve_comm(comm_arg, env)
                        if comm_arg is not None else "<world>")
                if comm is None:
                    comm = "<world>"
                self.ops.append(Op(
                    comm, "nb" if "I" in fname else kind, fname,
                    call.lineno, tuple(guards), dict(env),
                    _arg(call, peer_kw, peer_pos), _arg(call, "tag", None),
                    _arg(call, "count", None),
                    any(lp.rank_dep for lp in loops)))
                return
            if splice and fname in self.funcs:
                self._splice(self.funcs[fname], call, env, guards, loops)

    def _splice(self, fn: ast.FunctionDef, call: ast.Call,
                env: Dict[str, Sym], guards: List[Guard],
                loops: List[_Loop]) -> None:
        """One-level call-graph resolution: walk the callee's body with
        its parameters bound to the caller's argument expressions."""
        params = [a.arg for a in fn.args.args]
        callee_env: Dict[str, Sym] = {}
        for i, p in enumerate(params):
            a = _arg(call, p, i)
            if a is not None:
                callee_env[p] = Sym(a, dict(env))
        defaults = fn.args.defaults
        if defaults:
            for p, d in zip(params[-len(defaults):], defaults):
                callee_env.setdefault(p, Sym(d, {}))
        self._walk_block(fn.body, callee_env, list(guards), list(loops),
                         splice=False)


# -- module-level entry ------------------------------------------------------

def _top_functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    out: Dict[str, ast.FunctionDef] = {}
    for n in tree.body:
        if isinstance(n, ast.FunctionDef):
            out[n.name] = n
    return out


def _called_names(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            out.add(n.func.id)
    return out


def all_functions(tree: ast.Module):
    """Every function/method in the module (for the per-function local
    rules)."""
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n


def collect_roots(tree: ast.Module) -> Tuple[List[RootOps],
                                             List[RankLoopColl]]:
    """Comm-graph analysis roots: the module body plus every top-level or
    method function that is NOT called from within this module (called
    helpers are analyzed spliced into their callers, so a rank-guarded
    helper whose caller supplies the matching branch stays clean)."""
    funcs = _top_functions(tree)
    called = _called_names(tree)
    roots: List[RootOps] = []
    rank_loops: List[RankLoopColl] = []

    col = OpCollector(funcs)
    col._walk_block(
        [s for s in tree.body
         if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))],
        {}, [], [], splice=True)
    roots.append(RootOps("<module>", col.ops))
    rank_loops.extend(col.rank_loops)

    for fn in all_functions(tree):
        if fn.name in called:
            continue
        col = OpCollector(funcs)
        col.walk_root(fn.body)
        roots.append(RootOps(fn.name, col.ops))
        rank_loops.extend(col.rank_loops)

    # called helpers still contribute MPL008 evidence standalone (a
    # rank-dependent collective loop is a local property)
    for fn in all_functions(tree):
        if fn.name not in called:
            continue
        col = OpCollector(funcs)
        col.walk_root(fn.body)
        rank_loops.extend(col.rank_loops)

    seen = set()
    uniq: List[RankLoopColl] = []
    for rl in rank_loops:
        key = (rl.line, rl.name)
        if key not in seen:
            seen.add(key)
            uniq.append(rl)
    return roots, uniq


# -- request flow (MPL005 / MPL006) ------------------------------------------

class _Req(NamedTuple):
    line: int
    name: str
    buf: Optional[str]


def _req_creation(stmt: ast.stmt) -> Optional[Tuple[Optional[str], _Req]]:
    """(target-name-or-None, request) when the statement creates a
    nonblocking request; an Expr statement that discards the handle
    returns target None."""
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and isinstance(stmt.targets[0], ast.Name):
        target, value = stmt.targets[0].id, stmt.value
    elif isinstance(stmt, ast.Expr):
        target, value = None, stmt.value
    else:
        return None
    if not isinstance(value, ast.Call):
        return None
    name = None
    mc = _attr_call(value)
    if mc is not None and mc[1] in NONBLOCKING_METHODS:
        name = mc[1]
    elif isinstance(value.func, ast.Name) \
            and value.func.id in NONBLOCKING_FUNCS:
        name = value.func.id
    if name is None:
        return None
    buf = None
    lowered = name.lower()
    if "recv" in lowered and "send" not in lowered:
        b = _arg(value, "buf", None)
    else:
        b = _arg(value, "buf", 0) if lowered.startswith(("isend", "mpi_i")) \
            else _arg(value, "buf", None)
    if isinstance(b, ast.Name):
        buf = b.id
    return target, _Req(stmt.lineno, name, buf)


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _completion_targets(stmt: ast.AST) -> Set[str]:
    """Variable names this statement completes: ``v.wait()``-style calls
    and names passed (directly or in a list literal) to MPI_Wait*."""
    out: Set[str] = set()
    for n in ast.walk(stmt):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute) \
                and n.func.attr in _COMPLETION_METHODS \
                and isinstance(n.func.value, ast.Name):
            out.add(n.func.value.id)
        elif isinstance(n.func, ast.Name) \
                and n.func.id in _COMPLETION_FUNCS:
            for a in n.args:
                out.update(_names_in(a))
    return out


def _buffer_writes(stmt: ast.stmt) -> Set[Tuple[str, int]]:
    """(name, line) for every subscript/augmented store through a plain
    name in the statement — the buffer-mutation shapes MPL006 prices."""
    out: Set[Tuple[str, int]] = set()
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, ast.AugAssign):
        targets = [stmt.target]
    elif isinstance(stmt, ast.AnnAssign):
        targets = [stmt.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Subscript) \
                    and isinstance(n.value, ast.Name):
                out.add((n.value.id, stmt.lineno))
            elif isinstance(stmt, ast.AugAssign) and isinstance(n, ast.Name) \
                    and n is stmt.target:
                out.add((n.id, stmt.lineno))
    return out


class _ReqFlow:
    def __init__(self) -> None:
        self.issues: List[ReqIssue] = []
        self._flagged006: Set[Tuple[str, int]] = set()

    def run(self, body: Sequence[ast.stmt]) -> None:
        state: Dict[str, _Req] = {}
        exits: List[Dict[str, _Req]] = []
        end = self._block(body, state, exits)
        if end is not None:
            exits.append(end)
        leaked: Dict[str, _Req] = {}
        for snap in exits:
            for v, req in snap.items():
                leaked.setdefault(v, req)
        for v, req in sorted(leaked.items(), key=lambda kv: kv[1].line):
            self.issues.append(ReqIssue("MPL005", req.line, req.line,
                                        req.name, req.buf))

    def _block(self, body: Sequence[ast.stmt], state: Dict[str, _Req],
               exits: List[Dict[str, _Req]]) -> Optional[Dict[str, _Req]]:
        """Forward may-analysis; returns the fall-through state, or None
        when the block always terminates."""
        for stmt in body:
            if isinstance(stmt, ast.Return):
                self._uses(stmt, state)
                exits.append(dict(state))
                return None
            if isinstance(stmt, ast.Raise):
                # error path: request accounting is moot there
                return None
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                self._uses(stmt.test, state)
                s1 = self._block(stmt.body, dict(state), exits)
                s2 = self._block(stmt.orelse, dict(state), exits)
                if s1 is None and s2 is None:
                    return None
                state = self._merge(s1, s2)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                head = stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor)) \
                    else stmt.test
                self._uses(head, state)
                s = dict(state)
                for _ in range(2):  # loop body twice: fixpoint for joins
                    out = self._block(stmt.body, dict(s), exits)
                    s = self._merge(s, out)
                state = self._merge(
                    s, self._block(stmt.orelse, dict(s), exits))
                if state is None:
                    return None
                continue
            if isinstance(stmt, ast.Try):
                s1 = self._block(stmt.body, dict(state), exits)
                merged = self._merge(state, s1)
                for h in stmt.handlers:
                    merged = self._merge(
                        merged, self._block(h.body, dict(state), exits))
                merged = self._merge(
                    merged, self._block(stmt.orelse,
                                        dict(merged or state), exits))
                fin = self._block(stmt.finalbody,
                                  dict(merged or state), exits)
                state = fin if stmt.finalbody else (merged or {})
                if state is None:
                    return None
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._uses(item.context_expr, state)
                s = self._block(stmt.body, state, exits)
                if s is None:
                    return None
                state = s
                continue
            # simple statement
            created = _req_creation(stmt)
            self._uses(stmt, state, skip_value=(
                created is not None))
            self._writes(stmt, state)
            if created is not None:
                target, req = created
                key = target if target is not None \
                    else f"<discarded@{req.line}>"
                state[key] = req
        return state

    @staticmethod
    def _merge(a: Optional[Dict[str, _Req]],
               b: Optional[Dict[str, _Req]]) -> Optional[Dict[str, _Req]]:
        if a is None:
            return None if b is None else dict(b)
        if b is None:
            return dict(a)
        out = dict(a)
        for k, v in b.items():
            out.setdefault(k, v)
        return out

    def _uses(self, node: ast.AST, state: Dict[str, _Req],
              skip_value: bool = False) -> None:
        """Apply completions, then escape-discharge any OTHER mention of
        a live request var (stored, passed, returned: the analysis can no
        longer prove anything, so it stays silent)."""
        if not state:
            return
        done = _completion_targets(node)
        for v in list(state):
            if v in done:
                state.pop(v, None)
        if skip_value:
            return
        mentioned = _names_in(node)
        for v in list(state):
            if v in mentioned:
                state.pop(v, None)  # escaped: conservatively discharged

    def _writes(self, stmt: ast.stmt, state: Dict[str, _Req]) -> None:
        if not state:
            return
        writes = _buffer_writes(stmt)
        if not writes:
            return
        for v, req in list(state.items()):
            if req.buf is None:
                continue
            for name, line in writes:
                if name == req.buf:
                    key = (req.buf, req.line)
                    if key not in self._flagged006:
                        self._flagged006.add(key)
                        self.issues.append(ReqIssue(
                            "MPL006", line, req.line, req.name, req.buf))
                    state.pop(v, None)
                    break


def request_flow(body: Sequence[ast.stmt]) -> List[ReqIssue]:
    """MPL005/006 evidence for one function body (or module body)."""
    flow = _ReqFlow()
    flow.run(body)
    return flow.issues
