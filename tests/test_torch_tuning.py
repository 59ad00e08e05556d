"""The port's tuned dispatch (``mpi_tpu_torch/tuning``) against the
reference's (``mpi_tpu/tuning``): ``validate`` accepts and refuses the
same documents with the same messages, ``match`` prefers trusted rows,
``pick`` / ``explain`` / ``last_decision`` and the ``tuned_table_*``
pvars move the same way on the same programs (the wire schedule a pinned
row selects is visible in ``msgs_sent``), the arena's gates on shm rank
threads, ``run(..., tuning_table=)``, ``MPI_TPU_TUNING_TABLE``, the
launcher's ``--tuning-table`` and the sweep ``python -m
mpi_tpu_torch.tools.tune``.  The checklist is ``tests/test_tuning.py``;
its hierarchical cases (``:370``, ``:412``, ``:431``, ``:441``) are held
in ``tests/test_torch_hierarchical.py``."""

import json
import os
import socket as _socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mpi_tpu_torch
from mpi_tpu import mpit as ref_mpit
from mpi_tpu import tuning as ref_tuning
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import coll_sm, mpit, tuning
from mpi_tpu_torch.tools import tune
from mpi_tpu_torch.transport.local import run_local
from mpi_tpu_torch.transport.shm import run_shm
from tests.test_shm_backend import run_shm_world as ref_run_shm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _doc(rows, hostname=None, cpu_count=None, version=tuning.VERSION,
         fmt=tuning.FORMAT):
    return {
        "format": fmt, "version": version,
        "fingerprint": {
            "hostname": _socket.gethostname() if hostname is None
            else hostname,
            "cpu_count": (os.cpu_count() or 1) if cpu_count is None
            else cpu_count,
            "transports": ["local", "shm"],
        },
        "rows": rows,
    }


def _row(transport="local", nranks=2, collective="allreduce", lo=0,
         hi=None, algorithm="ring", trusted=True, **extra):
    d = {"transport": transport, "nranks": nranks,
         "collective": collective, "lo_bytes": lo, "hi_bytes": hi,
         "algorithm": algorithm, "trusted": trusted}
    d.update(extra)
    return d


@pytest.fixture()
def table(tmp_path):
    """Write a doc and activate it in both packages (their cvars);
    deactivate afterwards."""
    paths = []

    def activate(doc):
        p = tmp_path / f"table{len(paths)}.json"
        p.write_text(json.dumps(doc))
        paths.append(p)
        ref_mpit.cvar_write("tuning_table_path", str(p))
        mpit.cvar_write("tuning_table_path", str(p))
        return str(p)

    try:
        yield activate
    finally:
        ref_mpit.cvar_write("tuning_table_path", "")
        mpit.cvar_write("tuning_table_path", "")


def port_local(fn, p, **kw):
    return run_local(fn, p, device="cpu", timeout=60, **kw)


# -- format / validation -------------------------------------------------------


def test_format_constants_are_the_references():
    assert tuning.FORMAT == ref_tuning.FORMAT
    assert tuning.VERSION == ref_tuning.VERSION
    assert tuning.KNOWN_ALGORITHMS == ref_tuning.KNOWN_ALGORITHMS
    assert tuning.fingerprint() == ref_tuning.fingerprint()
    sizes = [1024, 64, 1 << 20, 1024]
    assert tuning.band_edges(sizes) == ref_tuning.band_edges(sizes)


def test_load_validate_and_band_match(tmp_path):
    doc = _doc([_row(lo=0, hi=1024, algorithm="recursive_halving"),
                _row(lo=1024, hi=None, algorithm="ring")])
    p = tmp_path / "t.json"
    p.write_text(json.dumps(doc))
    tabs = (ref_tuning.TuningTable.load(str(p)),
            tuning.TuningTable.load(str(p)))
    for key in (("local", 2, "allreduce", 16), ("local", 2, "allreduce", 1024),
                ("local", 2, "allreduce", 1 << 30), ("shm", 2, "allreduce", 16),
                ("local", 3, "allreduce", 16), ("local", 2, "alltoall", 16)):
        got = [t.match(*key) for t in tabs]
        assert [g and g.as_dict() for g in got] == \
            [got[0] and got[0].as_dict()] * 2
    assert tabs[1].matches_machine()


@pytest.mark.parametrize("mutate", [
    lambda d: d.update(version=99),
    lambda d: d.update(format="nope"),
    lambda d: d.update(fingerprint={"hostname": 3}),
    lambda d: d.update(rows="x"),
    lambda d: d["rows"].append(_row(collective="frobnicate")),
    lambda d: d["rows"].append(_row(algorithm="quantum")),
    lambda d: d["rows"].append(_row(lo=-1)),
    lambda d: d["rows"].append(_row(lo=64, hi=64)),
    lambda d: d["rows"].append(_row(nranks=1)),
    lambda d: d["rows"].append(_row(nranks=3, algorithm="recursive_halving")),
    lambda d: d["rows"].append(_row(trusted="yes")),
    lambda d: d["rows"].append(_row(transport="")),
    lambda d: d["rows"].append("row"),
    lambda d: d["rows"].append(_row(collective="sm_reduce",
                                    algorithm="flat")),
])
def test_reject_malformed_with_the_references_message(tmp_path, mutate):
    doc = _doc([_row()])
    mutate(doc)
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(doc))
    msgs = []
    for mod in (ref_tuning, tuning):
        with pytest.raises(mod.TuningTableError) as ei:
            mod.TuningTable.load(str(p))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    # the strict cvar writer raises and keeps the previous (empty) table
    with pytest.raises(tuning.TuningTableError):
        mpit.cvar_write("tuning_table_path", str(p))
    assert mpit.cvar_read("tuning_table_path") == ""


@pytest.mark.parametrize("text", ["{not json", "[1, 2]", "null"])
def test_reject_non_tables_alike(tmp_path, text):
    p = tmp_path / "nope.json"
    p.write_text(text)
    msgs = []
    for mod in (ref_tuning, tuning):
        with pytest.raises(mod.TuningTableError) as ei:
            mod.TuningTable.load(str(p))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_valid_documents_load_alike():
    for rows in ([_row()], [_row(collective="sm_allreduce", transport="shm",
                                 algorithm="chunked", hi=4096, note="x")],
                 []):
        doc = _doc(rows)
        assert [r.as_dict() for r in tuning.validate(doc)] == \
            [r.as_dict() for r in ref_tuning.validate(doc)]


def test_trusted_beats_untrusted(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(_doc([_row(algorithm="ring", trusted=False),
                                  _row(algorithm="rabenseifner")])))
    assert tuning.TuningTable.load(str(p)).match(
        "local", 2, "allreduce", 16).algorithm == "rabenseifner"
    p.write_text(json.dumps(_doc([_row(algorithm="ring", trusted=False)])))
    assert tuning.TuningTable.load(str(p)).match(
        "local", 2, "allreduce", 16).algorithm == "ring"


# -- resolver and auto dispatch ------------------------------------------------


def _sends(pkg_port, nranks, **kw):
    """msgs_sent of one allreduce world of 8 float32 (ring = 2(P-1) sends
    per rank, halving = 2 log2 P)."""
    m = mpit if pkg_port else ref_mpit
    before = m.pvar_read("msgs_sent")
    if pkg_port:
        res = port_local(lambda c: c.allreduce(torch.ones(8)), nranks, **kw)
        assert all(torch.equal(r, torch.full((8,), float(nranks)))
                   for r in res)
    else:
        ref_run_local(lambda c: c.allreduce(np.ones(8, np.float32)), nranks,
                      **kw)
    return m.pvar_read("msgs_sent") - before


def test_auto_cites_pinned_row(table):
    assert _sends(True, 4) == _sends(False, 4) == 16  # seed: halving
    table(_doc([_row(nranks=4, algorithm="ring")]))
    h0 = mpit.pvar_read("tuned_table_hits")
    assert _sends(True, 4) == 24  # ring: 6 sends per rank
    assert mpit.pvar_read("tuned_table_hits") - h0 == 4
    last = tuning.last_decision()
    assert last["algorithm"] == "ring" and last["source"] == "table:trusted"
    assert _sends(False, 4) == 24
    assert last == ref_tuning.last_decision()
    assert tuning.explain("local", 4, "allreduce", 32) == \
        ref_tuning.explain("local", 4, "allreduce", 32)


def test_no_table_is_seed_constants_and_counted():
    mpit.cvar_write("tuning_table_path", "")
    f0 = mpit.pvar_read("tuned_table_fallbacks")
    assert _sends(True, 4) == 16
    assert mpit.pvar_read("tuned_table_fallbacks") - f0 == 4
    assert tuning.explain("local", 4, "allreduce", 32)["source"] == "seed"


def test_active_table_unmatched_row_records_seed(table):
    table(_doc([_row(collective="alltoall", algorithm="pairwise")]))
    f0 = mpit.pvar_read("tuned_table_fallbacks")
    port_local(lambda c: c.allreduce(torch.ones(8)), 2)
    assert mpit.pvar_read("tuned_table_fallbacks") - f0 == 2
    last = tuning.last_decision()
    assert last["source"] == "seed" and last["collective"] == "allreduce"


def test_fingerprint_mismatch_falls_back_to_seed(table):
    table(_doc([_row(algorithm="ring")], hostname="definitely-not-here"))
    assert "fingerprint mismatch" in tuning.reason()
    h0 = mpit.pvar_read("tuned_table_hits")
    assert _sends(True, 2) == 4
    assert mpit.pvar_read("tuned_table_hits") == h0


def test_inapplicable_row_falls_back(table):
    table(_doc([_row(nranks=3, algorithm="sm")]))
    h0 = mpit.pvar_read("tuned_table_hits")
    res = port_local(lambda c: c.allreduce(torch.ones(4)), 3)
    assert all(torch.equal(r, torch.full((4,), 3.0)) for r in res)
    assert mpit.pvar_read("tuned_table_hits") == h0


def test_pick_counts_exactly_one_per_consult(table):
    table(_doc([_row(algorithm="ring")]))
    h0 = mpit.pvar_read("tuned_table_hits")
    f0 = mpit.pvar_read("tuned_table_fallbacks")
    port_local(lambda c: c.allreduce(torch.ones(8)), 2)
    assert (mpit.pvar_read("tuned_table_hits") - h0,
            mpit.pvar_read("tuned_table_fallbacks") - f0) == (2, 0)


def test_reduce_scatter_and_alltoall_rows_steer_the_wire(table):
    table(_doc([_row(collective="reduce_scatter", algorithm="ring"),
                _row(collective="alltoall", algorithm="pairwise")]))
    h0 = mpit.pvar_read("tuned_table_hits")
    res = port_local(lambda c: (c.reduce_scatter(torch.ones(2, 3)),
                                c.alltoall(torch.ones(2, 3) * c.rank)), 2)
    assert torch.equal(res[0][0], torch.full((3,), 2.0))
    assert mpit.pvar_read("tuned_table_hits") - h0 == 4


def test_nonblocking_plan_consults_the_table(table):
    table(_doc([_row(nranks=4, algorithm="ring")]))
    h0 = mpit.pvar_read("tuned_table_hits")
    res = port_local(lambda c: c.iallreduce(torch.ones(8)).wait(), 4,
                     progress="thread")
    assert all(torch.equal(r, torch.full((8,), 4.0)) for r in res)
    assert mpit.pvar_read("tuned_table_hits") - h0 == 4


def test_run_tuning_table_param(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(_doc([_row(algorithm="ring")])))
    h0 = mpit.pvar_read("tuned_table_hits")
    mpi_tpu_torch.run(lambda c: c.allreduce(torch.ones(8)), backend="local",
                      nranks=2, device="cpu", tuning_table=str(p))
    assert mpit.pvar_read("tuned_table_hits") - h0 == 2
    assert mpit.cvar_read("tuning_table_path") == ""
    with pytest.raises(ValueError, match="--tuning-table"):
        mpi_tpu_torch.run(lambda c: 0, backend="self", device="cpu",
                          tuning_table=str(p))


def test_env_var_activates_table(tmp_path):
    """MPI_TPU_TUNING_TABLE is read lazily once per process: a fresh
    interpreter (not a rank world) serves from it."""
    p = tmp_path / "t.json"
    p.write_text(json.dumps(_doc([_row(algorithm="ring")])))
    prog = textwrap.dedent("""
        import torch
        from mpi_tpu_torch.transport.local import run_local
        from mpi_tpu_torch import mpit
        run_local(lambda c: c.allreduce(torch.ones(8)), 2, device="cpu")
        print("HITS", mpit.pvar_read("tuned_table_hits"))
    """)
    env = dict(os.environ, MPI_TPU_TUNING_TABLE=str(p), PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "HITS 2" in out.stdout, out.stdout


def test_launcher_tuning_table_reaches_every_rank(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(_doc([_row(transport="socket",
                                       algorithm="ring")])))
    script = tmp_path / "prog.py"
    out = tmp_path / "out"
    out.mkdir()
    script.write_text(textwrap.dedent(f"""
        import torch
        import mpi_tpu_torch
        from mpi_tpu_torch import mpit, tuning
        comm = mpi_tpu_torch.init()
        comm.allreduce(torch.ones(8))
        with open({str(out)!r} + f"/rank{{comm.rank}}.txt", "w") as f:
            f.write(str(mpit.pvar_read("tuned_table_hits")) + " "
                    + tuning.last_decision()["source"])
        mpi_tpu_torch.finalize()
    """))
    from mpi_tpu_torch import launcher

    assert launcher.main(["-n", "2", "--device", "cpu", "--timeout", "120",
                          "--tuning-table", str(p), str(script)]) == 0
    for r in range(2):
        assert (out / f"rank{r}.txt").read_text() == "1 table:trusted"


# -- the arena's gates on shm rank threads -------------------------------------


def test_sm_eager_gate_from_table(table):
    table(_doc([_row(transport="shm", collective="sm_allreduce",
                     algorithm="chunked"),
                _row(transport="shm", collective="allreduce",
                     algorithm="sm")]))
    h0 = mpit.pvar_read("coll_sm_hits")
    res = run_shm(lambda c: c.allreduce(torch.full((256,), 1.0 + c.rank,
                                                   dtype=torch.float64),
                                        algorithm="sm"), 2, device="cpu",
                  timeout=60)
    ref = ref_run_shm(lambda c: c.allreduce(np.full(256, 1.0 + c.rank),
                                            algorithm="sm"), 2)
    for g, r in zip(res, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    assert mpit.pvar_read("coll_sm_hits") > h0
    last = tuning.last_decision()
    assert (last["collective"], last["algorithm"]) == ("sm_allreduce",
                                                       "chunked")


def test_sm_reduce_gate_from_table(table):
    table(_doc([_row(transport="shm", collective="sm_reduce",
                     algorithm="tree")]))
    f0 = mpit.pvar_read("coll_sm_fallbacks")
    res = run_shm(lambda c: c.reduce(torch.full((64,), 1.0),
                                     algorithm="sm"), 2, device="cpu",
                  timeout=60)
    assert torch.equal(res[0], torch.full((64,), 2.0)) and res[1] is None
    assert mpit.pvar_read("coll_sm_fallbacks") > f0


def test_alltoall_pairwise_row_declines_inside_arena(table):
    table(_doc([_row(transport="shm", collective="alltoall",
                     algorithm="pairwise")]))

    def prog(comm):
        return comm.alltoall([torch.full((16,), float(comm.rank * 10 + d))
                              for d in range(2)])

    h0 = mpit.pvar_read("coll_sm_hits")
    f0 = mpit.pvar_read("coll_sm_fallbacks")
    th0 = mpit.pvar_read("tuned_table_hits")
    res = run_shm(prog, 2, device="cpu", timeout=60)
    for r, out in enumerate(res):
        assert torch.equal(torch.stack(out), torch.stack(
            [torch.full((16,), float(q * 10 + r)) for q in range(2)]))
    assert mpit.pvar_read("tuned_table_hits") > th0
    assert mpit.pvar_read("coll_sm_hits") == h0
    assert mpit.pvar_read("coll_sm_fallbacks") > f0


# -- the sweep -----------------------------------------------------------------


def test_tune_arena_capacity_and_seed_policy_mirror_the_reference():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import tune as ref_tune
    finally:
        sys.path.pop(0)
    for p in range(2, 9):
        assert tune.arena_capacity(p) == ref_tune._arena_capacity(p)
        for coll in ("allreduce", "reduce_scatter", "alltoall"):
            for nbytes in (1 << 10, 512 << 10, 2 << 20, 4 << 20):
                assert tune.seed_policy("shm", p, coll, nbytes) == \
                    ref_tune._seed_policy("shm", p, coll, nbytes)
    for coll in ("sm_allreduce", "sm_reduce"):
        for nbytes in (1 << 10, coll_sm._EAGER_BYTES, 1 << 20):
            assert tune.gate_seed(coll, nbytes) == \
                ref_tune._gate_seed(coll, nbytes)


def test_tune_sweep_writes_a_valid_table_that_serves(tmp_path, capsys):
    out = tmp_path / "table.json"
    assert tune.main(["--device", "cpu", "--ranks", "2", "--sizes",
                      "1024,65536", "--iters", "2", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    ref_tuning.validate(doc)  # the reference accepts the port's table
    colls = {(r["transport"], r["collective"]) for r in doc["rows"]}
    assert ("local", "allreduce") in colls and ("shm", "sm_reduce") in colls
    assert ("socket", "allreduce") in colls
    # socket and shm are measured as their worlds run: one process a rank
    assert doc["generated"]["ranks_as"] == {
        "local": "threads", "socket": "processes", "shm": "processes"}
    assert tune.main(["--check", str(out)]) == 0
    assert "OK" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(_doc([_row(algorithm="quantum")])))
    assert tune.main(["--check", str(bad)]) == 1
    h0 = mpit.pvar_read("tuned_table_hits")
    res = mpi_tpu_torch.run(lambda c: c.allreduce(torch.ones(256)),
                            backend="local", nranks=2, device="cpu",
                            tuning_table=str(out))
    assert all(torch.equal(r, torch.full((256,), 2.0)) for r in res)
    assert mpit.pvar_read("tuned_table_hits") - h0 == 2
    assert tuning.last_decision()["source"] == "table:trusted"
