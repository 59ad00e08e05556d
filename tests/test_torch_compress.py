"""The port's compressed collectives (``mpi_tpu_torch/compress.py``)
against the reference's (``mpi_tpu/compress.py``): the wire formats'
encode/decode bitwise on the same seeded inputs (NaN positions exact),
``resolve``'s declines and messages, and compressed allreduce /
reduce_scatter on local rank threads bitwise against
``mpi_tpu.transport.local.run_local`` (also with 64-byte segments forced
in both packages), on shm rank threads against the reference's shm world,
top-k with distinct magnitudes including the residual slots, and the
byte accounting.  The checklist is ``tests/test_compress.py``."""

import numpy as np
import pytest
import torch

from mpi_tpu import compress as ref_compress
from mpi_tpu import mpit as ref_mpit
from mpi_tpu import ops as ref_ops
from mpi_tpu.transport import codec as ref_codec
from mpi_tpu.transport.local import run_local as ref_run_local
from mpi_tpu_torch import compress, mpit, ops
from mpi_tpu_torch.transport import codec
from mpi_tpu_torch.transport.local import run_local
from mpi_tpu_torch.transport.shm import run_shm
from tests.test_shm_backend import run_shm_world as ref_run_shm
from tests.test_torch_host_local import assert_same, segments, to_torch  # noqa: F401


def port_local(fn, p, **kw):
    return run_local(fn, p, device="cpu", timeout=60, **kw)


def port_shm(fn, p):
    return run_shm(fn, p, device="cpu", timeout=60, ring_bytes=256 * 1024)


WORLDS = {"local": (ref_run_local, port_local), "shm": (ref_run_shm, port_shm)}


def payloads(p, n, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(n).astype(dtype) for _ in range(p)]


def distinct(p, n, seed=0):
    """Payloads whose magnitudes are distinct within each rank and after
    adding any residual: a unique top-k set in both packages."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(p):
        mags = (rng.permutation(n) + 1).astype(np.float32) / 8.0
        out.append(mags * np.where(rng.rand(n) < 0.5, -1.0, 1.0).astype(
            np.float32))
    return out


@pytest.fixture
def cvars():
    """Set a cvar in both packages; restored after the test."""
    saved = []

    def put(name, value):
        saved.append((name, ref_mpit.cvar_read(name), mpit.cvar_read(name)))
        ref_mpit.cvar_write(name, value)
        mpit.cvar_write(name, value)

    yield put
    for name, ref_v, port_v in reversed(saved):
        ref_mpit.cvar_write(name, ref_v)
        mpit.cvar_write(name, port_v)


def _special(n=4096, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([
        (rng.randn(n) * 10.0 ** rng.randint(-20, 20, n)),
        np.array([0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 2.0 ** -9,
                  -1.0 - 2.0 ** -9, 3.0e38, 3.4e38])]).astype(np.float32)


# -- the wire formats ------------------------------------------------------


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("case", ["random", "zeros", "empty", "inf", "nan"])
def test_bf16_encode_decode_bitwise(case):
    x = {"random": _special(), "zeros": np.zeros(33, np.float32),
         "empty": np.zeros(0, np.float32),
         "inf": np.array([1.0, np.inf, -np.inf, 2.5], np.float32),
         "nan": np.array([1.0, np.nan, -np.nan, 7.0], np.float32)}[case]
    want = ref_compress.BF16.encode_segs(x)[0]
    got = compress.BF16.encode_segs(torch.from_numpy(x))
    assert len(got) == 1 and got[0].dtype == torch.bfloat16
    nan = np.isnan(ref_compress.bf16_bits_to_f32(want))
    # NaN positions exact; NaN payload bits may differ (ROADMAP records it)
    np.testing.assert_array_equal(np.isnan(got[0].float().numpy()), nan)
    np.testing.assert_array_equal(_bits(got[0])[~nan], want[~nan])
    dec = compress.BF16.decode_segs(got).numpy()
    ref_dec = ref_compress.BF16.decode_segs([want])
    np.testing.assert_array_equal(np.isnan(dec), np.isnan(ref_dec))
    np.testing.assert_array_equal(dec[~nan], ref_dec[~nan])
    bits = compress.f32_to_bf16_bits(torch.from_numpy(x))
    np.testing.assert_array_equal(bits.numpy().view(np.uint16)[~nan],
                                  want[~nan])
    np.testing.assert_array_equal(
        compress.bf16_bits_to_f32(bits).numpy()[~nan], ref_dec[~nan])


def _int8_inputs(case):
    rng = np.random.RandomState(3)
    if case == "ties":
        # x / scale lands on k + 0.5 for every entry: round half to even
        amax = 127.0
        k = rng.randint(-126, 126, 2000).astype(np.float32)
        x = (k + 0.5).astype(np.float32)
        x[0] = amax
        return x
    return {"random": rng.randn(5000).astype(np.float32) * 3.0,
            "zeros": np.zeros(17, np.float32),
            "empty": np.zeros(0, np.float32),
            "inf": np.array([1.0, 2.0, np.inf, 3.0], np.float32),
            "nan": np.array([1.0, np.nan, 4.0], np.float32),
            "tiny": (rng.randn(300) * 1e-30).astype(np.float32)}[case]


@pytest.mark.parametrize("case", ["random", "ties", "zeros", "empty", "inf",
                                  "nan", "tiny"])
def test_int8_encode_decode_bitwise(case):
    x = _int8_inputs(case)
    want = ref_compress.INT8.encode_segs(x)
    got = compress.INT8.encode_segs(torch.from_numpy(x))
    assert [g.dtype for g in got] == [
        torch.float32, torch.int8 if want[1].dtype == np.int8
        else torch.float32]
    np.testing.assert_array_equal(np.isnan(got[0].numpy()), np.isnan(want[0]))
    np.testing.assert_array_equal(got[0].numpy()[~np.isnan(want[0])],
                                  want[0][~np.isnan(want[0])])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    dec = compress.INT8.decode_segs(got).numpy()
    ref_dec = ref_compress.INT8.decode_segs(want)
    np.testing.assert_array_equal(dec, ref_dec)


def test_wire_nbytes_match_the_encodings():
    x = torch.randn(100)
    for fmt, ref_fmt in ((compress.BF16, ref_compress.BF16),
                         (compress.INT8, ref_compress.INT8)):
        segs = fmt.encode_segs(x)
        assert sum(s.numel() * s.element_size() for s in segs) == \
            fmt.wire_nbytes(100, 4) == ref_fmt.wire_nbytes(100, 4)


def test_decode_mismatch_is_typed_error():
    with pytest.raises(TypeError, match="wire"):
        compress.BF16.decode(torch.ones(4))
    with pytest.raises(TypeError, match="wire"):
        compress.BF16.decode(codec.Encoded("int8", [torch.ones(4,
                                                               dtype=torch.int8)]))


def test_codec_encoded_round_trip():
    enc = codec.Encoded("int8", [torch.tensor([0.5]),
                                 torch.arange(16, dtype=torch.int8)])
    assert enc.nbytes == 4 + 16
    head, bufs = codec.pack_raw_frame("ctx", 7, enc)
    body = head + b"".join(bytes(codec.byte_view(b)) if isinstance(
        b, torch.Tensor) else bytes(b) for b in bufs)
    ctx, tag, got = codec.parse_raw_body(body)
    assert (ctx, tag) == ("ctx", 7)
    assert type(got) is codec.Encoded and got.wire == "int8"
    assert torch.equal(got.segs[1], enc.segs[1])
    cp = codec.value_copy(enc)
    assert cp.wire == "int8" and cp.segs[0] is not enc.segs[0]
    assert torch.equal(cp.segs[0], enc.segs[0])
    mlen = codec.META.unpack_from(head)[0]
    _, _, plan = codec.parse_raw_meta(head[codec.META.size:
                                           codec.META.size + mlen])
    assert plan[0] == "wire" and plan[2] == "int8"
    host = codec.alloc_raw(plan, "cpu")
    dest = codec.finish_raw(plan, host, "cpu")
    assert type(dest) is codec.Encoded
    assert [d.dtype for d in dest.segs] == [torch.float32, torch.int8]
    # the reference's frame of the same encoding has the same shape
    ref_enc = ref_codec.Encoded("int8", [np.array([0.5], np.float32),
                                         np.arange(16, dtype=np.int8)])
    assert ref_enc.nbytes == enc.nbytes


# -- resolve -----------------------------------------------------------------


class _Comm:
    pass


@pytest.mark.parametrize("algo,dtype,opname,expect", [
    ("compressed", np.float32, "sum", "compressed:bf16"),
    ("compressed:int8", np.float32, "max", "compressed:int8"),
    ("compressed:bf16", np.float64, "min", "compressed:bf16"),
    ("compressed:topk", np.float32, "sum", "compressed:topk"),
    ("compressed:topk", np.float32, "max", "auto"),
    ("compressed", np.int64, "sum", "auto"),
    ("compressed:bf16", np.float32, "prod", "auto"),
])
def test_resolve_matches_the_reference(algo, dtype, opname, expect):
    arr = np.ones(300, dtype)
    f0 = (ref_mpit.pvar_read("compress_fallbacks"),
          mpit.pvar_read("compress_fallbacks"))
    rw, ra, rc = ref_compress.resolve(_Comm(), "allreduce", arr,
                                      ref_ops.BY_NAME[opname], algo)
    pw, pa, pc = compress.resolve(_Comm(), "allreduce",
                                  torch.from_numpy(arr),
                                  ops.BY_NAME[opname], algo)
    assert ra == pa == expect
    assert rc == pc
    assert (rw is None) == (pw is None)
    assert ((ref_mpit.pvar_read("compress_fallbacks") - f0[0])
            == (mpit.pvar_read("compress_fallbacks") - f0[1])
            == (1 if expect == "auto" else 0))


def test_resolve_unknown_wire_dtype_message(monkeypatch):
    monkeypatch.setattr(ref_compress, "_WIRE_DTYPE", "fp4")
    monkeypatch.setattr(compress, "_WIRE_DTYPE", "fp4")
    msgs = []
    for mod, arr, op in ((ref_compress, np.ones(3, np.float32), ref_ops.SUM),
                         (compress, torch.ones(3), ops.SUM)):
        with pytest.raises(ValueError) as ei:
            mod.resolve(_Comm(), "allreduce", arr, op, "compressed")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_cvars_validate_like_the_reference(cvars):
    for name, bad in (("compress_wire_dtype", "fp4"),
                      ("compress_topk_ratio", 0)):
        msgs = []
        for mod in (ref_mpit, mpit):
            with pytest.raises(ValueError) as ei:
                mod.cvar_write(name, bad)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
    cvars("compress_wire_dtype", "int8")
    assert mpit.cvar_read("compress_wire_dtype") == "int8"


# -- collectives: bitwise against the reference --------------------------------


@pytest.mark.parametrize("algo", ["compressed:bf16", "compressed:int8",
                                  "compressed"])
@pytest.mark.parametrize("p", [2, 3, 4])
def test_allreduce_bitwise_local(algo, p, segments):
    data = payloads(p, 777, seed=p)
    ref = ref_run_local(lambda c: c.allreduce(data[c.rank], algorithm=algo), p)
    got = port_local(lambda c: c.allreduce(to_torch(data[c.rank]),
                                           algorithm=algo), p)
    assert_same(ref, got)


@pytest.mark.parametrize("algo", ["compressed:bf16", "compressed:int8"])
@pytest.mark.parametrize("opname", ["max", "min"])
def test_allreduce_max_min_bitwise(algo, opname):
    p = 3
    data = payloads(p, 301, seed=5)
    ref = ref_run_local(lambda c: c.allreduce(
        data[c.rank], ref_ops.BY_NAME[opname], algorithm=algo), p)
    got = port_local(lambda c: c.allreduce(
        to_torch(data[c.rank]), ops.BY_NAME[opname], algorithm=algo), p)
    assert_same(ref, got)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_allreduce_f64_and_bf16_payloads(dtype):
    import ml_dtypes

    p = 2
    if dtype == "float64":
        data = payloads(p, 257, seed=3, dtype=np.float64)
    else:
        data = [(np.arange(256, dtype=np.float32) % 128 + r).astype(
            ml_dtypes.bfloat16) for r in range(p)]
    ref = ref_run_local(lambda c: c.allreduce(data[c.rank],
                                              algorithm="compressed"), p)
    got = port_local(lambda c: c.allreduce(to_torch(data[c.rank]),
                                           algorithm="compressed"), p)
    assert_same(ref, got)
    assert got[0].dtype == (torch.float64 if dtype == "float64"
                            else torch.bfloat16)


def test_allreduce_non_finite_int8_bitwise():
    p = 2
    data = payloads(p, 64, seed=12)
    data[0][7] = np.inf
    data[1][9] = np.nan
    ref = ref_run_local(lambda c: c.allreduce(data[c.rank],
                                              algorithm="compressed:int8"), p)
    got = port_local(lambda c: c.allreduce(to_torch(data[c.rank]),
                                           algorithm="compressed:int8"), p)
    assert_same(ref, got)
    assert np.isinf(got[0][7].item()) and np.isnan(got[0][9].item())


@pytest.mark.parametrize("algo", ["compressed:bf16", "compressed:int8"])
@pytest.mark.parametrize("p", [2, 3])
def test_reduce_scatter_bitwise(algo, p, segments):
    rng = np.random.RandomState(2)
    blocks = [rng.randn(p, 40).astype(np.float32) for _ in range(p)]
    ref = ref_run_local(lambda c: c.reduce_scatter(blocks[c.rank],
                                                   algorithm=algo), p)
    got = port_local(lambda c: c.reduce_scatter(to_torch(blocks[c.rank]),
                                                algorithm=algo), p)
    assert_same(ref, got)


def test_reduce_scatter_ragged_blocks_decline():
    def prog(c, pkg_torch, algo):
        mk = (lambda a: torch.from_numpy(a)) if pkg_torch else (lambda a: a)
        blocks = [mk(np.arange(i + 1, dtype=np.float64) * (c.rank + 1))
                  for i in range(c.size)]
        return c.reduce_scatter(blocks, algorithm=algo)

    f0 = mpit.pvar_read("compress_fallbacks")
    ref = ref_run_local(lambda c: prog(c, False, "compressed"), 2)
    got = port_local(lambda c: prog(c, True, "compressed"), 2)
    assert mpit.pvar_read("compress_fallbacks") - f0 == 2
    assert_same(ref, got)


def test_topk_rejected_for_reduce_scatter():
    msgs = []
    for runner, mk in ((ref_run_local, lambda: np.ones((2, 4), np.float32)),
                       (port_local, lambda: torch.ones(2, 4))):
        def prog(c):
            with pytest.raises(ValueError) as ei:
                c.reduce_scatter(mk(), algorithm="compressed:topk")
            return str(ei.value)
        msgs.append(runner(prog, 2)[0])
    assert msgs[0] == msgs[1]


def test_declines_are_the_references():
    p = 2
    ints = [np.arange(5, dtype=np.int64) * (r + 1) for r in range(p)]
    f0 = mpit.pvar_read("compress_fallbacks")
    ref = ref_run_local(lambda c: c.allreduce(ints[c.rank],
                                              algorithm="compressed"), p)
    got = port_local(lambda c: c.allreduce(to_torch(ints[c.rank]),
                                           algorithm="compressed"), p)
    assert_same(ref, got)
    ref = ref_run_local(lambda c: c.allreduce(np.full(4, 2.0, np.float32),
                                              ref_ops.PROD,
                                              algorithm="compressed"), p)
    got = port_local(lambda c: c.allreduce(torch.full((4,), 2.0), ops.PROD,
                                           algorithm="compressed"), p)
    assert_same(ref, got)
    assert mpit.pvar_read("compress_fallbacks") - f0 == 2 * p


def test_compressed_composes_with_the_progress_engine(cvars):
    cvars("collective_segment_bytes", 64)
    p = 2
    data = payloads(p, 1000, seed=8)
    ref = ref_run_local(lambda c: c.allreduce(data[c.rank],
                                              algorithm="compressed:bf16"),
                        p, progress="thread")
    got = port_local(lambda c: c.allreduce(to_torch(data[c.rank]),
                                           algorithm="compressed:bf16"),
                     p, progress="thread")
    assert_same(ref, got)
    got = port_local(lambda c: c.iallreduce(to_torch(data[c.rank]),
                                            algorithm="compressed:bf16").wait(),
                     p, progress="thread")
    assert_same(ref, got)


# -- top-k ---------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [0.05, 0.25, 2.0])
def test_topk_bitwise_with_residuals(ratio, cvars):
    cvars("compress_topk_ratio", ratio)
    p, n = 3, 200
    data = distinct(p, n, seed=11)

    def prog(c, as_t):
        mk = to_torch if as_t else (lambda a: a)
        outs = [c.allreduce(mk(data[c.rank]), algorithm="compressed:topk")
                for _ in range(3)]
        slot = next(iter(c.__dict__["_compress_residuals"].values()))
        return outs + [slot]

    ref = ref_run_local(lambda c: prog(c, False), p)
    got = port_local(lambda c: prog(c, True), p)
    assert_same(ref, got)


def test_topk_all_zero_and_k_ge_n(cvars):
    cvars("compress_topk_ratio", 0.1)
    ref = ref_run_local(lambda c: c.allreduce(np.zeros(37, np.float32),
                                              algorithm="compressed:topk"), 2)
    got = port_local(lambda c: c.allreduce(torch.zeros(37),
                                           algorithm="compressed:topk"), 2)
    assert_same(ref, got)
    for n in (0, 1, 9, 10, 11, 1000):
        assert compress.topk_k(n) == ref_compress.topk_k(n)


def test_topk_compress_key_slots(cvars):
    cvars("compress_topk_ratio", 0.05)
    p, n = 2, 200
    a = distinct(p, n, seed=21)
    b = distinct(p, n, seed=22)

    def keyed(c, as_t):
        mk = to_torch if as_t else (lambda v: v)
        c.allreduce(mk(a[c.rank]), algorithm="compressed:topk",
                    compress_key="tensor-a")
        out = c.allreduce(mk(b[c.rank]), algorithm="compressed:topk",
                          compress_key="tensor-b")
        keys = sorted(k[1] for k in c.__dict__["_compress_residuals"])
        compress_mod = compress if as_t else ref_compress
        compress_mod.reset_residuals(c)
        assert "_compress_residuals" not in c.__dict__
        return out, keys

    ref = ref_run_local(lambda c: keyed(c, False), p)
    got = port_local(lambda c: keyed(c, True), p)
    assert_same(ref, got)
    assert got[0][1] == ["tensor-a", "tensor-b"]


def test_topk_non_sum_declines(cvars):
    cvars("compress_topk_ratio", 0.5)
    data = payloads(2, 20, seed=1)
    f0 = mpit.pvar_read("compress_fallbacks")
    ref = ref_run_local(lambda c: c.allreduce(data[c.rank], ref_ops.MAX,
                                              algorithm="compressed:topk"), 2)
    got = port_local(lambda c: c.allreduce(to_torch(data[c.rank]), ops.MAX,
                                           algorithm="compressed:topk"), 2)
    assert_same(ref, got)
    assert mpit.pvar_read("compress_fallbacks") - f0 == 2


def test_topk_wire_indices_have_the_references_dtype():
    assert compress._idx_dtype(10) == torch.int32
    assert compress._idx_dtype(1 << 31) == torch.int64
    assert ref_compress._idx_dtype(10) == np.int32


# -- shm worlds: the arena's compressed slot path and the wire ring ------------


@pytest.mark.parametrize("algo", ["compressed:bf16", "compressed:int8"])
@pytest.mark.parametrize("n", [1 << 10, 3 << 14])
def test_shm_compressed_bitwise(algo, n):
    """1 Ki elements ride the arena's encoded slots; 48 Ki elements are
    above the eager gate and take the compressed wire ring."""
    p = 3
    data = payloads(p, n, seed=6)
    names = ("coll_sm_hits", "bytes_pickled_sent")
    b0 = {k: mpit.pvar_read(k) for k in names}
    ref = ref_run_shm(lambda c: c.allreduce(data[c.rank], algorithm=algo), p)
    got = port_shm(lambda c: c.allreduce(to_torch(data[c.rank]),
                                         algorithm=algo), p)
    assert_same(ref, got)
    hits = mpit.pvar_read("coll_sm_hits") - b0["coll_sm_hits"]
    assert hits == (p if n == 1 << 10 else 0)
    assert mpit.pvar_read("bytes_pickled_sent") == b0["bytes_pickled_sent"]


def test_bf16_halves_raw_bytes_zero_pickle():
    p, n = 2, 1 << 16
    data = payloads(p, n, seed=0)
    names = ("bytes_raw_sent", "bytes_pickled_sent", "bytes_compressed_saved")
    b0 = {k: mpit.pvar_read(k) for k in names}
    port_shm(lambda c: c.allreduce(to_torch(data[c.rank]), algorithm="ring"),
             p)
    b1 = {k: mpit.pvar_read(k) for k in names}
    port_shm(lambda c: c.allreduce(to_torch(data[c.rank]),
                                   algorithm="compressed:bf16"), p)
    b2 = {k: mpit.pvar_read(k) for k in names}
    plain = b1["bytes_raw_sent"] - b0["bytes_raw_sent"]
    comp = b2["bytes_raw_sent"] - b1["bytes_raw_sent"]
    assert plain == 2 * p * (p - 1) * n * 4 // p
    assert comp * 2 == plain
    assert b2["bytes_pickled_sent"] == b0["bytes_pickled_sent"]
    assert (b2["bytes_compressed_saved"] - b1["bytes_compressed_saved"]
            == plain - comp)
