"""The port's static MPI linter against the reference's: the same
``(file, line, code)`` findings of ``mpi_tpu_torch.verify.lint`` and
``mpi_tpu.verify.lint`` over every file of ``tests/lint_corpus/`` and
over the source programs of ``tests/test_verify.py``'s lint tests; the
port's CLI (``python -m mpi_tpu_torch.tools.mpilint``) with ``--format
json``, ``--baseline`` and its stale-entry warnings, as
``tests/test_lint.py`` holds the reference's; and the port's own
examples (``mpi_tpu_torch/examples/``) lint clean with the port's CLI."""

import ast
import contextlib
import glob
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from mpi_tpu.verify import lint as ref_lint
from mpi_tpu_torch.tools import mpilint
from mpi_tpu_torch.verify import lint
from mpi_tpu_torch.verify.lint import _rank_eq_literal, lint_file, lint_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "lint_corpus")
EXAMPLES = os.path.join(REPO, "mpi_tpu_torch", "examples")

_CORPUS = sorted(glob.glob(os.path.join(CORPUS, "mpl*.py")))
_BUGGY = [p for p in _CORPUS if not p.endswith("_clean.py")]
_CLEAN = [p for p in _CORPUS if p.endswith("_clean.py")]


def _expected_rule(path: str) -> str:
    return os.path.basename(path).split("_")[0].upper()


def _key(findings):
    return [(os.path.relpath(f.file, REPO), f.line, f.code) for f in findings]


def test_corpus_is_complete():
    assert len(_BUGGY) == 18 and len(_CLEAN) == 9
    assert {_expected_rule(p) for p in _BUGGY} == {
        f"MPL00{i}" for i in range(1, 10)}


@pytest.mark.parametrize("path", _CORPUS,
                         ids=[os.path.basename(p) for p in _CORPUS])
def test_corpus_findings_are_the_references(path):
    got = lint_file(path)
    assert _key(got) == _key(ref_lint.lint_file(path))
    assert [f.msg for f in got] == [f.msg for f in ref_lint.lint_file(path)]
    if path in _BUGGY:
        assert len(got) == 1 and got[0].code == _expected_rule(path)
    else:
        assert got == []


@pytest.mark.parametrize("rule", ["mpl001", "mpl002"])
def test_symbolic_variant_is_v1_blind_v2_caught(rule):
    def v1_triggers(path):
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read())
        return sum(1 for node in ast.walk(tree)
                   if isinstance(node, ast.If)
                   and _rank_eq_literal(node.test) is not None)

    assert v1_triggers(os.path.join(CORPUS, f"{rule}_literal.py")) > 0
    sym = os.path.join(CORPUS, f"{rule}_symbolic.py")
    assert v1_triggers(sym) == 0
    (f,) = lint_file(sym)
    assert f.code == rule.upper()


def test_path_sensitive_leak_caught():
    src = open(os.path.join(CORPUS, "mpl005_symbolic.py")).read()
    assert ".wait()" in src
    (f,) = lint_source(src, "mpl005_symbolic.py")
    assert f.code == "MPL005"


# The source programs of tests/test_verify.py's lint tests, as strings
# (a seeded bug written as code here would be a finding of the repo's own
# lint gate over tests/).
_SOURCES = {
    "rank_conditional_bcast": (
        "def main(comm):\n"
        "    if comm.rank == 0:\n"
        "        data = comm.bcast(x, root=0)\n"
        "    else:\n"
        "        data = None\n"),
    "matched_bcast": (
        "def main(comm):\n"
        "    if comm.rank == 0:\n"
        "        data = comm.bcast(big, root=0)\n"
        "    else:\n"
        "        data = comm.bcast(None, root=0)\n"),
    "bcast_outside": (
        "def main(comm):\n"
        "    data = big if comm.rank == 0 else None\n"
        "    data = comm.bcast(data, root=0)\n"),
    "send_send_cycle": (
        "def main(comm):\n"
        "    if comm.rank == 0:\n"
        "        comm.send(a, 1)\n"
        "        b = comm.recv(source=1)\n"
        "    if comm.rank == 1:\n"
        "        comm.send(c, 0)\n"
        "        d = comm.recv(source=0)\n"),
    "recv_first": (
        "def main(comm):\n"
        "    if comm.rank == 0:\n"
        "        comm.send(a, 1)\n"
        "        b = comm.recv(source=1)\n"
        "    if comm.rank == 1:\n"
        "        d = comm.recv(source=0)\n"
        "        comm.send(c, 0)\n"),
    "count_truncation": (
        "def main(comm):\n"
        "    if comm.rank == 0:\n"
        "        MPI_Send(buf, dest=1, datatype=dt, count=8)\n"
        "    if comm.rank == 1:\n"
        "        out = MPI_Recv(source=0, datatype=dt, buf=b, count=4)\n"),
    "revoked": (
        "def recover(comm):\n"
        "    comm.revoke()\n"
        "    comm.allreduce(x)\n"),
    "revoked_in_try": (
        "def recover(comm):\n"
        "    comm.revoke()\n"
        "    try:\n"
        "        comm.allreduce(x)\n"
        "    except Exception:\n"
        "        pass\n"),
    "revoked_with_handler": (
        "def recover(comm):\n"
        "    comm.set_errhandler(h)\n"
        "    comm.revoke()\n"
        "    comm.allreduce(x)\n"),
    "suppressed": (
        "def main(comm):\n"
        "    if comm.rank == 0:\n"
        "        comm.barrier()  # mpilint: ok\n"),
    "torch_inplace_write": (
        "def main(comm, buf):\n"
        "    req = comm.irecv(source=0, buf=buf)\n"
        "    buf.copy_(other)\n"
        "    buf[0] = 1\n"
        "    req.wait()\n"),
}

_EXPECTED = {"rank_conditional_bcast": [("MPL001", 3)],
             "send_send_cycle": ["MPL002"], "count_truncation": ["MPL003"],
             "revoked": ["MPL004"], "torch_inplace_write": [("MPL006", 4)]}


@pytest.mark.parametrize("name", sorted(_SOURCES))
def test_source_findings_are_the_references(name):
    src = _SOURCES[name]
    got = lint_source(src, "prog.py")
    ref = ref_lint.lint_source(src, "prog.py")
    assert [(f.line, f.code, f.msg) for f in got] == \
        [(f.line, f.code, f.msg) for f in ref]
    want = _EXPECTED.get(name, [])
    assert [f.code if isinstance(w, str) else (f.code, f.line)
            for f, w in zip(got, want)] == want
    assert len(got) == len(want)


def test_torch_inplace_method_is_not_seen_by_mpl006():
    """Recorded difference kept from the reference: MPL006 sees an
    item assignment into a live receive buffer, not an in-place method
    call (``buf.copy_(...)`` here, ``np.copyto`` there)."""
    src = ("def main(comm, buf):\n"
           "    req = comm.irecv(source=0, buf=buf)\n"
           "    buf.copy_(other)\n"
           "    req.wait()\n")
    assert lint_source(src, "prog.py") == []
    assert ref_lint.lint_source(src, "prog.py") == []


# -- the CLI ------------------------------------------------------------------


def _run_cli(*argv, cwd=REPO):
    """The CLI's ``main`` in this process (its exit code and stdout), run
    from ``cwd`` as the baseline keys are relative to it."""
    out = io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            code = mpilint.main(list(argv))
    finally:
        os.chdir(here)
    return SimpleNamespace(returncode=code, stdout=out.getvalue(), stderr="")


def test_cli_json_format_over_corpus():
    proc = _run_cli("--format", "json", "tests/lint_corpus")
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert not doc["ok"]
    assert sorted((f["file"], f["line"], f["code"]) for f in doc["findings"]) \
        == sorted(_key(ref_lint.lint_paths([CORPUS])))
    for f in doc["findings"]:
        assert set(f) == {"file", "line", "code", "msg"}


def test_cli_baseline_subtraction(tmp_path):
    bad = tmp_path / "prog.py"
    bad.write_text("def main(comm):\n"
                   "    if comm.rank == 0:\n"
                   "        comm.barrier()\n")
    proc = _run_cli(str(bad), cwd=str(tmp_path))
    assert proc.returncode == 1 and "MPL001" in proc.stdout
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"entries": [
        {"file": "prog.py", "code": "MPL001", "count": 1, "why": "fixture"}]}))
    proc = _run_cli("--baseline", str(base), str(bad), cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "1 baselined" in proc.stdout
    bad.write_text("def main(comm):\n"
                   "    if comm.rank == 0:\n"
                   "        comm.barrier()\n"
                   "def other(comm):\n"
                   "    if comm.rank == 1:\n"
                   "        comm.barrier()\n")
    proc = _run_cli("--baseline", str(base), str(bad), cwd=str(tmp_path))
    assert proc.returncode == 1 and "new finding" in proc.stdout


def test_cli_stale_baseline_entry_warns(tmp_path):
    ok = tmp_path / "prog.py"
    ok.write_text("def main(comm):\n    comm.barrier()\n")
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"entries": [
        {"file": "prog.py", "code": "MPL001", "count": 1,
         "why": "was fixed since"}]}))
    proc = _run_cli("--baseline", str(base), str(ok), cwd=str(tmp_path))
    assert proc.returncode == 0 and "stale baseline entry" in proc.stdout
    proc = _run_cli("--format", "json", "--baseline", str(base), str(ok),
                    cwd=str(tmp_path))
    assert json.loads(proc.stdout)["stale_baseline"] == [
        {"file": "prog.py", "code": "MPL001"}]


def test_port_examples_lint_clean():
    """The port's own examples hold to the reference's bar for its
    examples: clean outright, no allowance — through the module's entry
    point, as a user runs it."""
    assert lint.lint_paths([EXAMPLES]) == []
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.tools.mpilint", EXAMPLES],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "mpilint: OK" in proc.stdout


def test_cli_flags_bad_file(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def main(comm):\n"
                   "    if comm.rank == 0:\n"
                   "        comm.barrier()\n")
    proc = _run_cli(str(bad))
    assert proc.returncode == 1 and "MPL001" in proc.stdout
