"""The port's host layer on the local backend (rank threads) against the
reference's: the same programs on the same seeded numpy inputs through
``mpi_tpu.transport.local.run_local`` and through
``mpi_tpu_torch.run(fn, backend="local", device="cpu")``.  Results must be
bitwise equal — the fold order is the same and elementwise IEEE ops give
the same bits — and the diagnoses the same strings.  The segmented
engine is also run with 64-byte segments in both packages, so that every
exchange is a multi-segment pipeline."""

import tempfile

import ml_dtypes
import numpy as np
import pytest
import torch

import mpi_tpu
import mpi_tpu_torch
from mpi_tpu import mpit as ref_mpit
from mpi_tpu import ops as ref_ops
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import mpit, ops

SIZES = [2, 3, 5, 8]


def port_run(fn, n):
    return mpi_tpu_torch.run(fn, backend="local", nranks=n, device="cpu")


def ref_run(fn, n):
    return ref_run_local(fn, n)


@pytest.fixture(params=["default", "small"])
def segments(request):
    """Each collective runs at the transports' own segment size and with
    64-byte segments forced in both packages' cvars."""
    if request.param == "default":
        yield request.param
        return
    old = (ref_mpit.cvar_read("collective_segment_bytes"),
           mpit.cvar_read("collective_segment_bytes"))
    ref_mpit.cvar_write("collective_segment_bytes", 64)
    mpit.cvar_write("collective_segment_bytes", 64)
    yield request.param
    ref_mpit.cvar_write("collective_segment_bytes", old[0])
    mpit.cvar_write("collective_segment_bytes", old[1])


def to_torch(a):
    """A numpy array (ml_dtypes bfloat16 included) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def norm(x):
    """Results of either package as comparable numpy (bf16 as its bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return ("bf16", x.view(torch.int16).numpy().view(np.uint16))
        return x.numpy()
    if isinstance(x, np.ndarray) and x.dtype == ml_dtypes.bfloat16:
        return ("bf16", x.view(np.uint16))
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (np.generic, int, float, bool)):
        return np.asarray(x)
    return x


def assert_same(ref, got, where=""):
    ref, got = norm(ref), norm(got)
    _same(ref, got, where)


def _same(a, b, where):
    if isinstance(a, tuple) and a and a[0] == "bf16":
        assert isinstance(b, tuple) and b[0] == "bf16", (where, a, b)
        _same(a[1], b[1], where)
        return
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
        return
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (where, type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype,
                                                          a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), (where, a, b)
        return
    assert a == b, (where, a, b)


def both(prog, n, data, **kw):
    """Run ``prog(comm, inputs, mods)`` in both packages on the same data
    and compare every rank's result bitwise."""
    ref = ref_run(lambda c: prog(c, data, mpi_tpu, ref_ops, **kw), n)
    tdata = [to_torch(d) for d in data]
    got = port_run(lambda c: prog(c, tdata, mpi_tpu_torch, ops, **kw), n)
    for r in range(n):
        assert_same(ref[r], got[r], f"rank {r}")
    return got


def seeded(n, shape=(37,), dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype) == np.bool_:
        return [rng.random(shape) < 0.5 for _ in range(n)]
    if np.issubdtype(np.dtype(dtype), np.integer):
        return [rng.integers(-50, 50, shape).astype(dtype) for _ in range(n)]
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


# -- point-to-point ----------------------------------------------------------


def _p2p(c, data, m, o):
    out = []
    if c.rank == 0:
        for k in range(3):
            c.send(data[k], 1, tag=5)
        c.send(data[3 % len(data)], 1, tag=7)
        c.send({"meta": 1}, 1, tag=9)
        return out
    if c.rank == 1:
        out.append(c.recv(0, tag=7))                 # tag matching skips
        out.extend(c.recv(0, tag=5) for _ in range(3))  # FIFO per tag
        st = m.communicator.Status()
        out.append(c.recv(-1, -1, status=st))      # ANY_SOURCE, ANY_TAG
        out.append([st.source, st.tag, st.count_bytes])
    return out


def test_p2p_fifo_tags_wildcards():
    both(_p2p, 2, seeded(4, (5, 3)))


def _sendrecv_shift(c, data, m, o, wrap):
    p, r = c.size, c.rank
    got = c.sendrecv(data[r], (r + 1) % p, source=(r - 1) % p, sendtag=3,
                     recvtag=3)
    sh = c.shift(data[r], offset=1, wrap=wrap, fill=-1.0)
    sh2 = c.shift(data[r], offset=-2, wrap=wrap, fill=0.5)
    return [got, sh, sh2]


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_sendrecv_and_shift(n, wrap):
    both(_sendrecv_shift, n, seeded(n, (4,)), wrap=wrap)


def _probe(c, data, m, o):
    if c.rank == 0:
        c.send(data[0], 1, tag=11)
        c.send("opaque", 1, tag=12)
        return []
    st = m.communicator.Status()
    c.probe(0, 11, status=st)
    first = [st.source, st.tag, st.count_bytes]
    st2 = m.communicator.Status()
    c.probe(-1, 12, status=st2)
    second = [st2.source, st2.tag, st2.count_bytes]
    return [first, second, c.recv(0, 11), c.recv(0, 12),
            c.iprobe(0, 11)]


def test_probe_status_counts():
    both(_probe, 2, seeded(1, (6,), np.float64))


def _requests(c, data, m, o):
    p, r = c.size, c.rank
    reqs = [c.irecv((r - 1) % p, tag=t) for t in (1, 2)]
    sends = [c.isend(data[r], (r + 1) % p, tag=2),
             c.isend(data[r] * 2, (r + 1) % p, tag=1)]
    vals = [q.wait() for q in reqs] + [q.wait() for q in sends]
    pr = c.recv_init((r - 1) % p, tag=4)
    ps = c.send_init(data[r], (r + 1) % p, tag=4)
    out = []
    for _ in range(2):
        pr.start()
        ps.start()
        ps.wait()
        out.append(pr.wait())
    return vals + out


@pytest.mark.parametrize("n", [2, 3])
def test_irecv_and_persistent_requests(n):
    both(_requests, n, seeded(n, (3,)))


def test_irecv_buf_filled_in_place():
    def prog(c):
        if c.rank == 0:
            c.send(torch.arange(4.0), 1, tag=0)
            return None
        buf = torch.zeros(4)
        c.irecv(0, 0, buf=buf).wait()
        return buf
    assert torch.equal(port_run(prog, 2)[1], torch.arange(4.0))


# -- collectives -------------------------------------------------------------

ALLREDUCE_ALGOS = ["auto", "ring", "recursive_halving", "rabenseifner",
                   "reduce_bcast", "fused"]


def _allreduce(c, data, m, o, algo, op):
    return c.allreduce(data[c.rank], getattr(o, op), algorithm=algo)


def _pow2_only(algos, pow2_algo):
    """(n, algorithm) pairs; ``pow2_algo`` runs on power-of-two groups only."""
    return [(n, a) for n in SIZES for a in algos
            if a != pow2_algo or not n & (n - 1)]


@pytest.mark.parametrize("n,algo", _pow2_only(ALLREDUCE_ALGOS,
                                              "recursive_halving"))
def test_allreduce_algorithms(n, algo, segments):
    for shape in [(), (1,), (7,), (250,), (13, 11)]:
        both(_allreduce, n, seeded(n, shape, np.float32, seed=n), algo=algo,
             op="SUM")


OPS_DTYPES = [
    ("SUM", np.float32), ("SUM", np.float64), ("SUM", np.int32),
    ("SUM", np.int64), ("SUM", np.bool_), ("PROD", np.float32),
    ("PROD", np.int64), ("MAX", np.float32), ("MAX", np.int32),
    ("MAX", np.bool_), ("MIN", np.float64), ("MIN", np.int64),
    ("LAND", np.bool_), ("LOR", np.bool_), ("LXOR", np.bool_),
    ("BAND", np.int32), ("BOR", np.int64), ("BXOR", np.int32),
    ("BXOR", np.bool_),
]


@pytest.mark.parametrize("op,dtype", OPS_DTYPES)
@pytest.mark.parametrize("algo", ["ring", "rabenseifner", "reduce_bcast"])
def test_allreduce_ops_dtypes(op, dtype, algo, segments):
    n = 5
    both(_allreduce, n, seeded(n, (41,), dtype, seed=3), algo=algo, op=op)


@pytest.mark.parametrize("algo", ["ring", "recursive_halving", "rabenseifner"])
def test_allreduce_bfloat16(algo, segments):
    """bfloat16 against ml_dtypes.bfloat16 arrays in the reference: each
    add rounds to bfloat16 in both, in the same order."""
    n = 4
    data = [a.astype(ml_dtypes.bfloat16) for a in seeded(n, (67,), np.float32, 5)]
    both(_allreduce, n, data, algo=algo, op="SUM")


def _user_op(c, data, m, o, algo):
    if m is mpi_tpu:
        op = o.make_op(lambda a, b: np.maximum(a, b) * 1.0 + 0.0, -np.inf,
                       name="umax")
    else:
        op = o.make_op(lambda a, b: torch.maximum(a, b) * 1.0 + 0.0,
                       float("-inf"), name="umax")
    return c.allreduce(data[c.rank], op, algorithm=algo)


@pytest.mark.parametrize("algo", ["ring", "recursive_halving", "rabenseifner"])
def test_allreduce_user_op(algo, segments):
    both(_user_op, 4, seeded(4, (57,), np.float32, 3), algo=algo)


def test_scalar_result_type():
    """A Python scalar payload becomes a 0-d tensor (the reference returns
    a numpy scalar of the same value and dtype)."""
    ref = ref_run(lambda c: c.allreduce(c.rank + 1), 3)
    got = port_run(lambda c: c.allreduce(c.rank + 1), 3)
    for a, b in zip(ref, got):
        assert isinstance(b, torch.Tensor) and b.ndim == 0
        assert b.dtype == torch.int64 and int(b) == int(a) == 6
    got = port_run(lambda c: c.allreduce(1.5), 2)
    assert got[0].dtype == torch.float64 and float(got[0]) == 3.0


def _reduce(c, data, m, o, root):
    return c.reduce(data[c.rank], o.SUM, root=root)


@pytest.mark.parametrize("n", SIZES)
def test_reduce(n, segments):
    for root in (0, n - 1):
        both(_reduce, n, seeded(n, (29,)), root=root)


def _bcast(c, data, m, o, root, obj):
    payload = data[c.rank] if obj == "array" else {"r": c.rank, "k": [1, 2]}
    return c.bcast(payload if c.rank == root else None, root=root)


@pytest.mark.parametrize("obj", ["array", "object"])
@pytest.mark.parametrize("n", SIZES)
def test_bcast(n, obj, segments):
    for root in (0, n // 2):
        both(_bcast, n, seeded(n, (33,)), root=root, obj=obj)


def test_bcast_segmented_tree():
    """A 1 MiB tensor on 5 ranks takes the segmented pipelined tree."""
    n = 5
    both(_bcast, n, seeded(n, (1 << 18,), np.float32), root=1, obj="array")


def _allgather(c, data, m, o, algo):
    return c.allgather(data[c.rank], algorithm=algo)


@pytest.mark.parametrize("n,algo", _pow2_only(["auto", "ring", "doubling"],
                                              "doubling"))
def test_allgather(n, algo, segments):
    both(_allgather, n, seeded(n, (3, 4), np.int64), algo=algo)


def _allgather_objects(c, data, m, o, algo):
    return c.allgather(("r", c.rank), algorithm=algo)


@pytest.mark.parametrize("algo", ["ring", "doubling"])
def test_allgather_objects(algo):
    both(_allgather_objects, 4, seeded(4), algo=algo)


def _alltoall(c, data, m, o):
    p, r = c.size, c.rank
    return c.alltoall([data[r][d] for d in range(p)])


@pytest.mark.parametrize("n", SIZES)
def test_alltoall(n, segments):
    both(_alltoall, n, seeded(n, (n, 6), np.float64))


def _barrier_scan(c, data, m, o):
    c.barrier()
    return [c.scan(data[c.rank], o.SUM), c.exscan(data[c.rank], o.MAX),
            c.scan(data[c.rank], o.PROD)]


@pytest.mark.parametrize("n", SIZES)
def test_barrier_scan_exscan(n, segments):
    both(_barrier_scan, n, seeded(n, (9,), np.int64))


def _reduce_scatter(c, data, m, o, kind):
    blocks = data[c.rank]
    if kind == "list":
        blocks = [blocks[i] for i in range(c.size)]
    return c.reduce_scatter(blocks, o.SUM)


@pytest.mark.parametrize("kind", ["array", "list"])
@pytest.mark.parametrize("n", SIZES)
def test_reduce_scatter(n, kind, segments):
    both(_reduce_scatter, n, seeded(n, (n, 17), np.float32, seed=n),
         kind=kind)


def test_reduce_scatter_segmented_at_1mib():
    both(_reduce_scatter, 3, seeded(3, (3, 1 << 17), np.float32), kind="array")


def _scatter_gather(c, data, m, o, root):
    parts = [data[root][i] for i in range(c.size)] if c.rank == root else None
    got = c.scatter(parts, root=root)
    return [got, c.gather(data[c.rank][0], root=root)]


@pytest.mark.parametrize("n", SIZES)
def test_scatter_gather(n):
    both(_scatter_gather, n, seeded(n, (n, 5)), root=n - 1)


def _vector(c, data, m, o):
    p, r = c.size, c.rank
    counts = [(i % 3) + 1 for i in range(p)]
    ag = c.allgatherv(data[r], counts)
    gv = c.gatherv(data[r], counts, root=0)
    sv = c.scatterv(data[0][:sum(counts)] if r == 0 else None, counts, root=0)
    mat = [[(i + j) % 3 for j in range(p)] for i in range(p)]
    av = c.alltoallv([data[r] for _ in range(p)], mat)
    return [ag, gv, sv, av]


@pytest.mark.parametrize("n", SIZES)
def test_vector_collectives(n):
    both(_vector, n, seeded(n, (3 * n, 2)))


def _maxloc(c, data, m, o):
    return list(c.maxloc(data[c.rank])) + list(c.minloc(data[c.rank]))


def test_maxloc_minloc():
    both(_maxloc, 5, seeded(5, (11,), np.int32))


# -- communicator management -------------------------------------------------


def _split(c, data, m, o):
    sub = c.split(c.rank % 2, key=-c.rank)
    nested = sub.split(sub.rank // 2)
    d = c.dup()
    # dup isolation: the same tag on the parent and the dup never mix
    p, r = c.size, c.rank
    c.send(data[r], (r + 1) % p, tag=1)
    d.send(data[r] * 2, (r + 1) % p, tag=1)
    from_dup = d.recv((r - 1) % p, tag=1)
    from_parent = c.recv((r - 1) % p, tag=1)
    opt_out = c.split(None if r == 0 else 1)
    return [sub.rank, sub.size, sub.allreduce(data[r]), nested.rank,
            nested.size, nested.allreduce(data[r], algorithm="ring"),
            from_dup, from_parent, opt_out is None,
            c.create(c.group().incl([0, 1])) is None]


@pytest.mark.parametrize("n", [3, 5, 8])
def test_split_nested_dup(n):
    both(_split, n, seeded(n, (6,)))


def test_error_in_one_rank_propagates():
    def prog(c):
        if c.rank == 2:
            raise ValueError("boom on rank 2")
        return c.allreduce(torch.ones(3))
    with pytest.raises(RuntimeError, match="rank 2 failed") as ei:
        port_run(prog, 4)
    assert "boom on rank 2" in str(ei.value)


# -- diagnoses ---------------------------------------------------------------


def _diag(fn, n=2):
    """The message each package raises from the same misuse."""
    msgs = []
    for run in (ref_run, port_run):
        with pytest.raises(RuntimeError) as ei:
            run(fn, n)
        msgs.append(str(ei.value.__cause__))
    return msgs


@pytest.mark.parametrize("coll,call", [
    ("allreduce", lambda c: c.allreduce(np.ones(2) if isinstance(c, mpi_tpu.P2PCommunicator)
                                        else torch.ones(2), algorithm="nope")),
    ("allgather", lambda c: c.allgather(1, algorithm="nope")),
    ("bcast", lambda c: c.bcast(1, algorithm="nope")),
    ("alltoall", lambda c: c.alltoall([1, 2], algorithm="nope")),
    ("barrier", lambda c: c.barrier(algorithm="nope")),
    ("tag", lambda c: c.send(1, 1 - c.rank, tag=-3)),
    ("counts", lambda c: c.allgatherv(np.ones(2) if isinstance(c, mpi_tpu.P2PCommunicator)
                                      else torch.ones(2), [1])),
    ("counts_neg", lambda c: c.allgatherv(np.ones(2) if isinstance(c, mpi_tpu.P2PCommunicator)
                                          else torch.ones(2), [1, -1])),
    ("matrix", lambda c: c.alltoallv([1, 2], [[1, 1]])),
    ("rows", lambda c: c.allgatherv(np.ones((1, 2)) if isinstance(c, mpi_tpu.P2PCommunicator)
                                    else torch.ones(1, 2), [2, 2])),
])
def test_diagnoses_are_the_references(coll, call):
    ref, got = _diag(call)
    assert ref == got


def _rank_raises(fn, item):
    """``fn`` raises NotImplementedError naming ROADMAP item ``item`` in a
    rank (run_local re-raises it as the cause of a RuntimeError)."""
    with pytest.raises(RuntimeError) as ei:
        port_run(fn, 2)
    assert isinstance(ei.value.__cause__, NotImplementedError), ei.value
    assert f"item {item}" in str(ei.value.__cause__)


def test_unported_features_name_their_roadmap_items():
    _rank_raises(lambda c: c.allreduce(torch.ones(2), algorithm="sm"), "16.4")
    _rank_raises(lambda c: c.bcast(torch.ones(2), algorithm="sm"), "16.4")
    _rank_raises(lambda c: c.allreduce(torch.ones(2),
                                       algorithm="compressed:bf16"), "16.3")
    _rank_raises(lambda c: c.reduce_scatter(torch.ones(2, 2),
                                            algorithm="compressed"), "16.3")
    _rank_raises(lambda c: c.iallreduce(torch.ones(2)), "16.2")
    _rank_raises(lambda c: c.win_create(torch.ones(2)), "16.4")
    with pytest.raises(NotImplementedError, match="16.4"):
        mpi_tpu_torch.run(lambda c: 0, backend="shm", nranks=2, device="cpu")
    for kw, item in [("fault_tolerance", "16.2"), ("verify", "16.2"),
                     ("progress", "16.2"), ("trace", "16.3"),
                     ("tuning_table", "16.3")]:
        with pytest.raises(NotImplementedError, match=item):
            mpi_tpu_torch.run(lambda c, **k: 0, backend="local", nranks=2,
                              device="cpu", **{kw: True})


def test_host_backends_never_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mpi_tpu_torch.run(lambda c: 0, backend="local", nranks=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mpi_tpu_torch.run(lambda c: 0, backend="self")


def test_run_local_and_transports_never_fall_back_to_the_cpu():
    """The public ``run_local`` and the transports resolve a missing
    device as ``run()`` does: the card, and without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    from mpi_tpu_torch.transport.local import LocalTransport, LocalWorld, run_local
    from mpi_tpu_torch.transport.socket import SocketTransport

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_local(lambda c: 0, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_local(lambda c: 0, 2, copy_payloads=False, recv_timeout=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalTransport(LocalWorld(1), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SocketTransport(0, 1, tempfile.mkdtemp(prefix="mpi_tpu_torch_test_rdv_"))


def test_draw_after_finalize_raises():
    """``init`` binds the process's host rank for ``rank_uniform`` /
    ``rank_normal``; ``finalize`` unbinds it, so a draw outside any world
    raises again instead of drawing as rank 0."""
    with pytest.raises(mpi_tpu_torch.SpmdContextError):
        mpi_tpu_torch.rank_uniform((2,), seed=0)
    comm = mpi_tpu_torch.init("self", device="cpu")
    try:
        assert comm.size == 1
        assert mpi_tpu_torch.rank_normal((3,), seed=1).shape == (3,)
    finally:
        mpi_tpu_torch.finalize()
    with pytest.raises(mpi_tpu_torch.SpmdContextError):
        mpi_tpu_torch.rank_uniform((2,), seed=0)
    with pytest.raises(mpi_tpu_torch.SpmdContextError):
        mpi_tpu_torch.rank_normal((2,), seed=0)


def test_self_backend_and_comm_device():
    got = mpi_tpu_torch.run(lambda c: (c.size, c.allreduce(torch.ones(2)),
                                       c.device.type),
                            backend="self", device="cpu")
    assert got[0] == 1 and torch.equal(got[1], torch.ones(2)) and got[2] == "cpu"
    assert mpi_tpu_torch.run(lambda c: c.device.type, backend="local",
                             nranks=2, device="cpu") == ["cpu", "cpu"]


def test_examples_run_unmodified_on_the_local_backend():
    """pi and Jacobi: the same program functions under the SPMD path and
    the local backend give bitwise-equal results."""
    from mpi_tpu_torch.examples.jacobi import jacobi_program
    from mpi_tpu_torch.examples.pi import pi_program

    spmd = mpi_tpu_torch.run(pi_program, nranks=4, device="cpu", n_per_rank=2000)
    host = port_run(lambda c: pi_program(c, n_per_rank=2000), 4)
    assert all(torch.equal(spmd[r], host[r]) for r in range(4))
    blocks, res = mpi_tpu_torch.run(jacobi_program, nranks=4, device="cpu",
                                    rows_per_rank=4, cols=8, iters=12)
    host = port_run(lambda c: jacobi_program(c, 4, 8, 12), 4)
    for r in range(4):
        assert torch.equal(blocks[r], host[r][0])
        assert torch.equal(res[r], host[r][1])


def _more_p2p(c, data, m, o):
    p, r = c.size, c.rank
    nxt, prv = (r + 1) % p, (r - 1) % p
    c.send(data[r], nxt, tag=21)
    c.send(data[r] + 1, nxt, tag=22)
    msg = c.mprobe(prv, 22)
    later = c.improbe(prv, 21)
    out = [msg.source, msg.tag, msg.recv(), later.recv() if later else None]
    out.append(c.exchange(data[r], [(i, (i + 2) % p) for i in range(p)]))
    out.append(c.exchange(data[r], [(0, 1)], fill=7.0))
    out.append(c.isendrecv(data[r], nxt, source=prv, sendtag=5, recvtag=5).wait())
    buf = data[r] * 1
    got = c.isendrecv_replace(buf, nxt, source=prv, sendtag=6, recvtag=6).wait()
    out += [got, buf]
    reqs = [c.send_init(data[r], nxt, tag=8), c.recv_init(prv, tag=8)]
    m.communicator.startall(reqs)
    out.append([q.wait() for q in reqs][1])
    return out


@pytest.mark.parametrize("n", [2, 3, 5])
def test_matched_probe_exchange_and_replace(n):
    both(_more_p2p, n, seeded(n, (4,), np.float64))


def _aliasing(c, data, m, o):
    x = data[c.rank]
    return [c.allreduce(x, algorithm="ring"), c.allreduce(x, algorithm="recursive_halving"),
            c.scan(x, o.SUM), c.reduce_scatter(x.reshape(c.size, -1)),
            c.allgather(x, algorithm="ring"), c.bcast(x if c.rank == 0 else None)]


@pytest.mark.parametrize("n", [2, 4])
def test_aliasing_world_copy_payloads_false(n, segments):
    """With copy_payloads=False messages are delivered by reference; the
    engine must snapshot what it sends and never fold into a peer's
    buffer — results as the reference's aliasing world gives them."""
    from mpi_tpu_torch.transport.local import run_local

    data = seeded(n, (n * 9,), np.float32, seed=11)
    ref = ref_run_local(lambda c: _aliasing(c, data, mpi_tpu, ref_ops), n,
                        copy_payloads=False)
    tdata = [to_torch(d) for d in data]
    got = run_local(lambda c: _aliasing(c, tdata, mpi_tpu_torch, ops), n,
                    copy_payloads=False, device=torch.device("cpu"))
    for r in range(n):
        assert_same(ref[r], got[r], f"rank {r}")
    assert all(torch.equal(t, to_torch(d)) for t, d in zip(tdata, data))


def test_recv_timeout_surfaces_a_lost_message():
    from mpi_tpu_torch.transport.base import RecvTimeout
    from mpi_tpu_torch.transport.local import run_local

    with pytest.raises(RuntimeError) as ei:
        run_local(lambda c: c.recv(1 - c.rank, tag=3), 2, recv_timeout=0.2,
                  device=torch.device("cpu"))
    assert isinstance(ei.value.__cause__, RecvTimeout)


def test_stress_threads_keep_counts_and_results_exact():
    """More rank threads than cores and a shortened switch interval: every
    message sent is received once (the shared pvar counters lose no
    update) and every fold stays exact."""
    import sys

    n = 16
    sent0, recv0 = mpit.pvar_read("msgs_sent"), mpit.pvar_read("msgs_received")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def prog(c):
            p, r = c.size, c.rank
            for k in range(20):
                c.send(torch.full((3,), float(k)), (r + 1) % p, tag=k % 3)
            got = [float(c.recv((r - 1) % p, tag=k % 3)[0]) for k in range(20)]
            s = c.allreduce(torch.arange(64, dtype=torch.int64) * (r + 1),
                            algorithm="ring")
            return got, s
        res = mpi_tpu_torch.run(prog, backend="local", nranks=n, device="cpu")
    finally:
        sys.setswitchinterval(old)
    want = torch.arange(64, dtype=torch.int64) * (n * (n + 1) // 2)
    for got, s in res:
        assert got == [float(k) for k in range(20)] and torch.equal(s, want)
    sent = mpit.pvar_read("msgs_sent") - sent0
    assert sent == mpit.pvar_read("msgs_received") - recv0 and sent >= n * 20


NAMED = [("bcast", "tree"), ("bcast", "fused"), ("reduce", "tree"),
         ("reduce", "fused"), ("alltoall", "pairwise"), ("alltoall", "fused"),
         ("barrier", "dissemination"), ("barrier", "fused"),
         ("scan", "doubling"), ("scan", "fused"), ("reduce_scatter", "ring"),
         ("reduce_scatter", "fused"), ("allgather", "fused"),
         ("allreduce", "fused")]


def _named(c, data, m, o, coll, algo):
    x = data[c.rank]
    if coll == "bcast":
        return c.bcast(x if c.rank == 1 else None, root=1, algorithm=algo)
    if coll == "reduce":
        return c.reduce(x, o.MAX, root=c.size - 1, algorithm=algo)
    if coll == "alltoall":
        return c.alltoall(x.reshape(c.size, -1), algorithm=algo)
    if coll == "barrier":
        return c.barrier(algorithm=algo)
    if coll == "scan":
        return c.scan(x, o.SUM, algorithm=algo)
    if coll == "reduce_scatter":
        return c.reduce_scatter(x.reshape(c.size, -1), o.SUM, algorithm=algo)
    return getattr(c, coll)(x, algorithm=algo)


@pytest.mark.parametrize("coll,algo", NAMED)
@pytest.mark.parametrize("n", SIZES)
def test_every_algorithm_name(n, coll, algo, segments):
    both(_named, n, seeded(n, (n * 5,), np.float32, seed=2), coll=coll, algo=algo)
