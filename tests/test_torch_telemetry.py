"""The port's flight recorder, histogram pvars, sessions and trace merger
against the reference's: the programs of ``tests/test_telemetry.py`` on
the same seeded inputs through ``mpi_tpu.transport.local.run_local(...,
trace=True)`` and ``mpi_tpu_torch.run(..., backend="local", device="cpu",
trace=True)``.  Per rank thread the ``(kind, name, attrs)`` event
sequences are equal (timestamps aside; blocked-wait spans, which depend
on timing, are compared by kind only), the Chrome exports carry the same
keys, the histograms read back the same counts and quantiles for the same
samples, and the port's ``tracecat`` finds the reference's offsets for
the same documents.  The reference's Prometheus renderer case
(``tests/test_telemetry.py:336``) and its serve case, stats and the
metrics scrape staying live while a pool heals a kill mid-lease
(``:374``), run unchanged on the port (``tests/test_torch_host_ref.py``,
the workers on the CPU); ``tests/test_torch_serve.py`` holds the
renderer byte for byte against the reference's.  Not written: the
``bench.py --verify-overhead`` leg (the benchmark folder is not
ported)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mpi_tpu_torch
from mpi_tpu import mpit as ref_mpit
from mpi_tpu import profiling as ref_profiling
from mpi_tpu import telemetry as ref_telemetry
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import mpit, profiling, telemetry
from mpi_tpu_torch.telemetry import Recorder
from mpi_tpu_torch.tools import tracecat
from tests.test_torch_host_local import to_torch
from tests.test_torch_host_ref import cpu_device_env  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

sys.path.insert(0, os.path.join(REPO, "tools"))
try:
    import tracecat as ref_tracecat
finally:
    sys.path.pop(0)


class Pkg:
    def __init__(self, port: bool):
        self.port = port
        self.mpit = mpit if port else ref_mpit
        self.telemetry = telemetry if port else ref_telemetry
        self.profiling = profiling if port else ref_profiling
        self.Recorder = Recorder if port else ref_telemetry.Recorder
        self.tracecat = tracecat if port else ref_tracecat

    def arr(self, a):
        return to_torch(np.asarray(a)) if self.port else np.array(a)

    def run(self, prog, n, **kw):
        if self.port:
            return mpi_tpu_torch.run(lambda c: prog(c, self), backend="local",
                                     nranks=n, device="cpu", **kw)
        return ref_run_local(lambda c: prog(c, self), n, timeout=60, **kw)


REF, PORT = Pkg(False), Pkg(True)
PKGS = [REF, PORT]


@pytest.fixture(autouse=True)
def _no_leaked_recorder():
    """A test that enables tracing must not leak a recorder into the rest
    of the run (every other test's off-mode contract needs REC None)."""
    for m in PKGS:
        m.telemetry.disable()
    yield
    for m in PKGS:
        m.telemetry.disable()


def _coll_mix(c, m):
    c.allreduce(m.arr(np.arange(8.0)))
    c.barrier()
    c.allgather(m.arr(np.arange(4.0)))
    c.alltoall([m.arr(np.arange(2.0))] * c.size)


def _session(m):
    ses = m.mpit.session_create()
    ses.reset_all()
    return ses


def _traced(m, prog, n, **kw):
    m.run(prog, n, trace=True, **kw)
    return m.telemetry.disable()


def _by_thread(rec, skip=("wait",)):
    """Each thread's (kind, name, attrs) sequence, sorted over threads:
    rank threads' ids differ between runs, their program order does not."""
    seqs = {}
    for e in rec.dump():
        if e["kind"] in skip:
            continue
        seqs.setdefault(e["tid"], []).append(
            (e["kind"], e["name"], json.dumps(e["attrs"], sort_keys=True)))
    return sorted(seqs.values())


# -- off-mode contract --------------------------------------------------------


def test_off_mode_zero_events_zero_hot_path_change():
    """Tracing off: zero events, and the wire accounting of a traced run
    of the same program is identical — in each package, and the port's
    equals the reference's."""
    got = {}
    for m in PKGS:
        ses = _session(m)
        m.run(_coll_mix, 2)
        assert m.telemetry.REC is None
        assert ses.read("trace_events") == 0
        off = (ses.read("payload_copies"), ses.read("bytes_pickled_sent"))
        ses = _session(m)
        _traced(m, _coll_mix, 2)
        assert ses.read("trace_events") > 0
        assert (ses.read("payload_copies"),
                ses.read("bytes_pickled_sent")) == off
        got[m.port] = off
    assert got[True] == got[False]


def test_trace_events_pvar_zero_across_module_surface():
    before = mpit.pvar_read("trace_events")
    PORT.run(_coll_mix, 2)
    assert mpit.pvar_read("trace_events") == before


# -- the recorder -------------------------------------------------------------


@pytest.mark.parametrize("capacity,n", [(4, 10), (8, 2)])
def test_ring_wraparound_keeps_newest(capacity, n):
    out = []
    for m in PKGS:
        rec = m.Recorder(capacity=capacity)
        for i in range(n):
            rec.emit("test", f"e{i}")
        out.append((rec.events_total, rec.dropped,
                    [e["name"] for e in rec.dump()]))
    assert out[0] == out[1]
    assert out[1][2] == [f"e{i}" for i in range(max(0, n - capacity), n)]


def test_enable_disable_lifecycle():
    rec = telemetry.enable(rank=7)
    assert telemetry.enable() is rec  # idempotent, first call wins
    rec.emit("test", "x")
    got = telemetry.disable()
    assert got is rec and telemetry.REC is None
    assert telemetry.recorder() is rec
    assert rec.find("test", "x")


def test_traced_event_sequences_are_the_references():
    """The same program, traced: per thread the same collective spans
    (name, resolved algorithm, payload bytes) in the same order."""
    ref = _by_thread(_traced(REF, _coll_mix, 2))
    got = _by_thread(_traced(PORT, _coll_mix, 2))
    assert got == ref
    colls = [json.loads(a) for s in got for k, n, a in s if k == "coll"]
    assert colls and all(a.get("algorithm") not in (None, "auto")
                         for a in colls)


def test_traced_state_machine_events_are_the_references():
    """The nonblocking collectives' ``sm`` arm / step / done events on a
    progress-engine world."""
    def prog(c, m):
        return c.iallreduce(m.arr(np.arange(4.0) + c.rank)).wait()

    ref = _traced(REF, prog, 3, progress="thread")
    got = _traced(PORT, prog, 3, progress="thread")

    def sm(rec):
        return sorted((e["name"], json.dumps(e["attrs"], sort_keys=True))
                      for e in rec.find("sm") if e["name"] != "step")
    assert sm(got) == sm(ref)
    assert {e["name"] for e in got.find("sm")} >= {"arm", "done"}


def test_traced_collectives_record_resolved_algorithm():
    rec = _traced(PORT, _coll_mix, 2)
    colls = rec.find("coll")
    assert {e["name"] for e in colls} == {
        "allreduce", "barrier", "allgather", "alltoall"}
    for e in colls:
        assert e["attrs"].get("algorithm") not in (None, "auto"), e
        assert e["dur_ns"] >= 0


def test_blocked_wait_span_past_noise_floor():
    def body(c, m):
        if c.rank == 0:
            c.recv(source=1, tag=5)
        else:
            time.sleep(0.08)
            c.send(m.arr(np.ones(2)), 0, tag=5)

    for m in PKGS:
        rec = _traced(m, body, 2)
        waits = rec.find("wait", "recv")
        assert waits, "blocked recv recorded no wait span"
        assert max(e["dur_ns"] for e in waits) >= 50_000_000
        assert any(e["attrs"].get("src") == 1 for e in waits)


def test_chrome_export_shape(tmp_path):
    docs = []
    for m in PKGS:
        rec = _traced(m, _coll_mix, 2)
        path = m.telemetry.export_chrome(str(tmp_path / f"{m.port}.json"),
                                         rec)
        doc = json.load(open(path))
        assert doc["mpi_tpu"]["events_total"] == rec.events_total
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        assert spans and all("dur" in e and "ts" in e for e in spans)
        docs.append(doc)
        rec.trace_dir = str(tmp_path / f"d{m.port}")
        out = rec.export_to_dir()
        assert os.path.basename(out).startswith("trace.r")
        assert tracecat.load_traces([rec.trace_dir])
    ref, got = docs
    assert set(got) == set(ref)
    assert set(got["mpi_tpu"]) == set(ref["mpi_tpu"])
    keys = lambda d: sorted({(e["ph"], tuple(sorted(e))) for e in d["traceEvents"]})  # noqa: E731
    assert keys(got) == keys(ref)


def test_export_chrome_without_recorder_raises(monkeypatch):
    monkeypatch.setattr(telemetry, "_LAST", None)  # nothing ever traced
    with pytest.raises(RuntimeError, match="enable tracing"):
        telemetry.export_chrome(os.path.join(REPO, "never.json"))


# -- cross-rank clock alignment (tools/tracecat.py) ---------------------------


def _frame_evt(name, ts, **args):
    return {"pid": 0, "tid": 1, "name": name, "cat": "frame",
            "ph": "i", "ts": ts, "args": args}


def _mk_doc(rank, events):
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "_path": f"trace.r{rank}.json",
            "mpi_tpu": {"rank": rank, "pid": 1000 + rank,
                        "wall_anchor_ns": 0, "mono_anchor_ns": 0,
                        "events_total": len(events), "dropped": 0,
                        "capacity": 64}}


def _two_rank_docs(true_off1=500.0, lat=10.0):
    d0, d1 = [], []
    for seq, t in ((1, 1000.0), (2, 2000.0)):
        d0.append(_frame_evt("send", t, dest=1, seq=seq))
        d1.append(_frame_evt("recv", t + lat - true_off1, src=0, seq=seq))
    for seq, t in ((1, 1500.0), (2, 2500.0)):
        d1.append(_frame_evt("send", t - true_off1, dest=0, seq=seq))
        d0.append(_frame_evt("recv", t + lat, src=1, seq=seq))
    return [_mk_doc(0, d0), _mk_doc(1, d1)]


def _three_rank_docs():
    true_off = {0: 0.0, 1: 300.0, 2: -200.0}
    docs_ev = {0: [], 1: [], 2: []}
    seq = 0
    for a in range(3):
        for b in range(3):
            if a == b:
                continue
            for _ in range(3):
                seq += 1
                t = 1000.0 * seq
                lat = 5.0 if a < b else 80.0  # asymmetric
                docs_ev[a].append(_frame_evt(
                    "send", t - true_off[a], dest=b, seq=seq))
                docs_ev[b].append(_frame_evt(
                    "recv", t + lat - true_off[b], src=a, seq=seq))
    return [_mk_doc(r, evs) for r, evs in docs_ev.items()]


@pytest.mark.parametrize("make", [_two_rank_docs, _three_rank_docs])
def test_tracecat_offsets_and_merge_are_the_references(make):
    docs = make()
    offsets = tracecat.estimate_offsets(docs)
    assert offsets == ref_tracecat.estimate_offsets(docs)
    assert tracecat.negative_latency_frames(docs, offsets) == 0
    merged = tracecat.merge(make())
    assert merged == ref_tracecat.merge(make())
    assert merged["mpi_tpu"]["negative_latency_frames"] == 0


def test_alignment_recovers_known_offsets():
    docs = _two_rank_docs()
    offsets = tracecat.estimate_offsets(docs)
    assert offsets[0] == 0.0
    assert offsets[1] == pytest.approx(500.0, abs=10.0)


def test_alignment_monotone_and_triangle_repair():
    docs = _three_rank_docs()
    meta = tracecat.merge(docs)["mpi_tpu"]
    assert meta["negative_latency_frames"] == 0 and len(meta["ranks"]) == 3
    off = {int(k): v for k, v in meta["offsets_us"].items()}
    for doc in _three_rank_docs():
        r = doc["mpi_tpu"]["rank"]
        shifted = [e["ts"] + off[r] for e in doc["traceEvents"]]
        assert shifted == sorted(shifted)


def test_tracecat_cli_report_and_merge(tmp_path):
    d0 = [_frame_evt("send", 100.0, dest=1, seq=1)]
    d1 = [_frame_evt("recv", 105.0, src=0, seq=1)]
    for r, evs in ((0, d0), (1, d1)):
        doc = _mk_doc(r, evs)
        doc.pop("_path")
        with open(tmp_path / f"trace.r{r}.1.json", "w") as f:
            json.dump(doc, f)
    assert tracecat.main([str(tmp_path), "--report"]) == 0
    out = tmp_path / "merged.json"
    assert tracecat.main([str(tmp_path), "-o", str(out)]) == 0
    doc = json.load(open(out))
    assert len(doc["mpi_tpu"]["ranks"]) == 2
    assert tracecat.main([str(tmp_path), "-o", str(out)]) == 0
    assert len(json.load(open(out))["traceEvents"]) == len(
        doc["traceEvents"])
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.tools.tracecat",
         str(tmp_path), "--report"], capture_output=True, text=True,
        cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-900:]


# -- histogram pvars and sessions ---------------------------------------------


def _hist_state(m, name):
    return (m.mpit.pvar_hist_read(name),
            [m.mpit.hist_quantile(name, q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            m.mpit.hist_cumulative(name))


def test_histogram_reads_are_the_references():
    name = "t_torch_test_hist_s"
    rng = np.random.default_rng(7)
    samples = list(rng.lognormal(-7.0, 2.0, size=200)) + [1e-3] * 100 + [1.0]
    for m in PKGS:
        m.mpit.pvar_hist_reset(name)
        for s in samples:
            m.mpit.hist_record(name, float(s))
    assert _hist_state(PORT, name) == _hist_state(REF, name)
    snap = mpit.pvar_hist_read(name)
    assert snap["count"] == 301
    counts = [c for _, c in mpit.hist_cumulative(name)]
    assert counts == sorted(counts) and counts[-1] == 301
    for m in PKGS:
        m.mpit.pvar_hist_reset(name)
    assert mpit.hist_quantile(name, 0.5) is None


def test_histogram_record_read_quantile():
    name = "t_torch_quantile_s"
    mpit.pvar_hist_reset(name)
    for _ in range(100):
        mpit.hist_record(name, 1e-3)
    mpit.hist_record(name, 1.0)
    snap = mpit.pvar_hist_read(name)
    assert snap["count"] == 101
    assert snap["sum_s"] == pytest.approx(1.1, rel=0.05)
    assert snap["min_s"] == pytest.approx(1e-3, rel=0.01)
    assert snap["max_s"] == pytest.approx(1.0, rel=0.01)
    assert 0.5e-3 <= mpit.hist_quantile(name, 0.5) <= 2e-3
    assert 0.5 <= mpit.hist_quantile(name, 1.0) <= 1.0
    mpit.pvar_hist_reset(name)


def test_histogram_unknown_name_raises():
    with pytest.raises(KeyError, match="unknown histogram"):
        mpit.pvar_hist_read("no_such_hist")
    with pytest.raises(ValueError, match="quantile"):
        mpit.hist_quantile("coll_latency_s", 1.5)


def test_histogram_preseeded_names_stable():
    for name in ("coll_latency_s", "lease_acquire_s", "link_heal_s"):
        assert name in mpit.pvar_hist_list()
        assert name in ref_mpit.pvar_hist_list()


@pytest.mark.parametrize("n", [2, 3])
def test_coll_latency_histogram_fed_by_traced_run(n):
    counts = []
    for m in PKGS:
        m.mpit.pvar_hist_reset("coll_latency_s")
        _traced(m, _coll_mix, n)
        counts.append(m.mpit.pvar_hist_read("coll_latency_s")["count"])
    assert counts[0] == counts[1] == 4 * n


def test_comm_stats_filled_by_traced_run():
    out = []
    for m in PKGS:
        _traced(m, _coll_mix, 3)
        stats = m.profiling.comm_stats()
        assert stats is not None
        json.loads(stats.to_json())
        out.append((stats.ops, stats.bytes))
    assert out[1] == out[0]
    assert out[1][0]["allreduce"] == 3 and out[1][1]["allreduce"] == 3 * 8 * 8


def test_session_reads_are_relative():
    ses = mpit.session_create()
    ses.reset("msgs_sent")
    base = mpit.pvar_read("msgs_sent")
    PORT.run(lambda c, m: c.send(m.arr(np.ones(2)), 1 - c.rank, tag=1)
             or c.recv(source=1 - c.rank, tag=1), 2)
    assert ses.read("msgs_sent") == mpit.pvar_read("msgs_sent") - base == 2
    ses.reset_all()
    assert all(ses.read(p) == 0 for p in mpit.pvar_list())
    assert set(mpit.pvar_list()) >= {"trace_events", "verify_clock_bytes"}


def test_trace_on_the_card_path_raises_without_a_card():
    """No fallback: without ``device="cpu"`` the traced local world needs
    the card, and no recorder is left enabled."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        mpi_tpu_torch.run(lambda c: 0, backend="local", nranks=2, trace=True)
    assert telemetry.REC is None


# -- process worlds: the launcher's --trace-dir -------------------------------


def test_launcher_trace_dir_writes_one_trace_per_rank(tmp_path):
    """``examples/host_trace.py`` under ``--trace-dir`` on CPU ranks: one
    Chrome trace per rank, merged with no negative-latency frame, every
    allreduce span naming the ring and its bytes, and each rank's record of
    spans, quantiles and ``comm_stats``."""
    traces, out = tmp_path / "traces", tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", "3",
         "--device", "cpu", "--trace-dir", str(traces), "--timeout", "120",
         os.path.join(REPO, "mpi_tpu_torch", "examples", "host_trace.py"),
         "--out", str(out), "--mib", "1", "--small-mib", "1"],
        capture_output=True, text=True, cwd=REPO, timeout=180)
    assert proc.returncode == 0, proc.stderr[-1500:]
    files = sorted(os.listdir(traces))
    assert [f.split(".")[1] for f in files] == ["r0", "r1", "r2"], files
    docs = tracecat.load_traces([str(traces)])
    offsets = tracecat.estimate_offsets(docs)
    assert tracecat.negative_latency_frames(docs, offsets) == 0
    spans = [e for d in docs for e in d["traceEvents"]
             if e.get("cat") == "coll" and e["name"] == "allreduce"]
    assert len(spans) == 3
    assert all(e["args"] == {"algorithm": "ring", "nbytes": 1 << 20}
               for e in spans)
    frames = [e for d in docs for e in d["traceEvents"]
              if e.get("cat") == "frame"]
    assert {e["name"] for e in frames} == {"send", "recv"}
    rec = json.load(open(out / "rank0.json"))
    assert rec["dropped"] == 0 and rec["events"] > 0
    assert rec["comm_stats"]["ops"]["allreduce"] == 1
    assert set(rec["small"]["calls"]) == {
        "bcast", "reduce", "allgather", "alltoall", "barrier", "scan",
        "reduce_scatter", "scatter", "gather"}
    assert rec["coll_latency_s"]["p50"] <= rec["coll_latency_s"]["p99"]


# -- the reference's serve telemetry cases, unchanged on the port ------------

def _reference_cases():
    from tests.test_torch_host_ref import port_cases

    return port_cases("test_telemetry", only=(
        "test_prometheus_text_render",
        "test_stats_and_scrape_survive_kill_mid_lease"))


_REF = _reference_cases()
test_prometheus_text_render = _REF["test_prometheus_text_render"]
# its pool's workers run on the CPU (MPI_TPU_DEVICE=cpu for the test)
test_stats_and_scrape_survive_kill_mid_lease = pytest.mark.usefixtures(
    "cpu_device_env")(_REF["test_stats_and_scrape_survive_kill_mid_lease"])
