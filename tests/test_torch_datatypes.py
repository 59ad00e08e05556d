"""Derived datatypes (``mpi_tpu_torch.datatypes``): ``pack_torch`` /
``unpack_torch`` against the JAX package's ``pack_jax`` / ``unpack_jax`` on
the same numpy inputs, over the cases of tests/test_datatypes.py:156, 228,
344, 373, 384 and 403.  A pack or unpack only moves elements, so every
comparison is bitwise (``assert_array_equal``).  One dtype case differs by
design and is recorded in ``test_dtype_checks``: a float64 map takes a
float32 buffer in JAX (its float64 → float32 canonicalisation) and is
refused by the port.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mpi_tpu_torch
from mpi_tpu import datatypes as jdt
from mpi_tpu_torch import datatypes as tdt


def both(ctor, *args):
    return ctor(jdt, *args), ctor(tdt, *args)


def test_bounds_checked():
    """tests/test_datatypes.py:156."""
    for dt in (jdt, tdt):
        t = dt.type_vector(4, 1, 5, np.float64).commit()
        pack, unpack = ((t.pack_jax, t.unpack_jax) if dt is jdt
                        else (t.pack_torch, t.unpack_torch))
        with pytest.raises(ValueError, match="buffer has"):
            pack(np.arange(10.0))
        with pytest.raises(ValueError, match="buffer has"):
            unpack(np.zeros(4), np.zeros(10))


@pytest.mark.parametrize("ctor", [
    lambda dt: dt.type_create_subarray([4, 6], [2, 3], [1, 2], np.float32),
    lambda dt: dt.type_vector(3, 2, 4, np.float32),
    lambda dt: dt.type_indexed([2, 1, 3], [0, 7, 12], np.float32),
    lambda dt: dt.type_create_resized(dt.type_contiguous(2, np.float32), 0, 5),
])
@pytest.mark.parametrize("count", [1, 2])
def test_pack_unpack_match_reference(ctor, count):
    """tests/test_datatypes.py:228, over more layouts and counts."""
    jt, tt = (ctor(dt).commit() for dt in (jdt, tdt))
    n = max(24, tt.extent * count)
    a = np.arange(n, dtype=np.float32) * 1.5 - 7.0
    want = np.asarray(jax.jit(lambda x: jt.pack_jax(x, count))(a))
    got = tt.pack_torch(torch.from_numpy(a), count)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tt.pack(a, count))
    out_j = np.asarray(jt.unpack_jax(want, np.zeros_like(a), count))
    out_t = tt.unpack_torch(got, torch.zeros(n), count)
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    host = np.zeros_like(a)
    tt.unpack(tt.pack(a, count), host, count)
    np.testing.assert_array_equal(out_t.numpy(), host)


def test_typed_halo_exchange_matches_reference():
    """tests/test_datatypes.py:344: pack the face, shift it one rank,
    unpack it, inside the SPMD program of each package."""
    import mpi_tpu

    n = 6

    def prog(lib, dt, comm):
        grid = lib.zeros((n, n)) + (comm.rank + 1.0)
        send_face = dt.type_create_subarray([n, n], [n, 1], [0, n - 2],
                                            np.float32).commit()
        recv_face = dt.type_create_subarray([n, n], [n, 1], [0, 0],
                                            np.float32).commit()
        if lib is jnp:
            got = comm.shift(send_face.pack_jax(grid), offset=1)
            return recv_face.unpack_jax(got, grid)
        got = comm.shift(send_face.pack_torch(grid), offset=1)
        return recv_face.unpack_torch(got, grid)

    want = np.asarray(mpi_tpu.run(lambda c: prog(jnp, jdt, c), backend="tpu",
                                  nranks=8))
    got = mpi_tpu_torch.run(lambda c: prog(torch, tdt, c), nranks=8,
                            device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    for r in range(8):
        assert np.all(got[r][:, 0] == (r - 1) % 8 + 1)
        assert np.all(got[r][:, 1:] == r + 1)


def test_dtype_checks():
    """tests/test_datatypes.py:373, and the one recorded difference."""
    t_j, t_t = both(lambda dt: dt.type_contiguous(2, np.int32).commit())
    for pack, unpack in ((t_j.pack_jax, t_j.unpack_jax),
                         (t_t.pack_torch, t_t.unpack_torch)):
        with pytest.raises(TypeError, match="dtype"):
            pack(np.zeros(4, np.float32))
        with pytest.raises(TypeError, match="dtype"):
            unpack(np.zeros(2, np.int32), np.zeros(4, np.float32))
    f_j, f_t = both(lambda dt: dt.type_contiguous(2, np.float64).commit())
    # JAX canonicalises float64 to float32 (x64 off): a float32 buffer passes
    assert f_j.pack_jax(np.arange(4.0, dtype=np.float32)).dtype == np.float32
    # the port's check is exact: float32 is refused, float64 is taken
    with pytest.raises(TypeError, match="buffer dtype torch.float32"):
        f_t.pack_torch(np.arange(4.0, dtype=np.float32))
    got = f_t.pack_torch(np.arange(4.0))
    assert got.dtype == torch.float64 and got.tolist() == [0.0, 1.0]


@pytest.mark.parametrize("base", [np.int16, np.longdouble])
def test_torch_path_base_dtypes(base):
    """The torch path's base dtypes come from one table: a base in it
    packs its own dtype, one outside it (no torch dtype) raises naming it."""
    t = tdt.type_contiguous(2, base).commit()
    if base is np.longdouble:
        with pytest.raises(TypeError, match="no torch dtype"):
            t.pack_torch(torch.zeros(4))
        return
    got = t.pack_torch(torch.arange(4).to(torch.int16))
    assert got.dtype == torch.int16 and got.tolist() == [0, 1]


def test_struct_pack_matches_host_bytes():
    """tests/test_datatypes.py:384: byte-based maps view the buffer as
    uint8, so the device pack equals the host pack byte for byte."""
    rec = np.dtype([("a", np.float32), ("b", np.int32)])
    t_j, t_t = both(lambda dt: dt.from_structured(rec).commit())
    buf = np.zeros(2, dtype=rec)
    buf["a"] = [1.5, -2.25]
    buf["b"] = [7, -9]
    host = t_t.pack(buf, count=2)
    dev_t = t_t.pack_torch(torch.from_numpy(buf.view(np.float32).copy()), count=2)
    dev_j = np.asarray(t_j.pack_jax(jnp.asarray(buf.view(np.float32)), count=2))
    np.testing.assert_array_equal(dev_t.numpy(), host)
    np.testing.assert_array_equal(dev_t.numpy(), dev_j)
    out_t = t_t.unpack_torch(dev_t, torch.zeros(4), count=2)
    out_j = np.asarray(t_j.unpack_jax(dev_j, jnp.zeros(4, jnp.float32), count=2))
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    assert out_t.dtype == torch.float32
    np.testing.assert_array_equal(out_t.numpy().view(rec)["b"], buf["b"])


def test_unpack_validates_payload():
    """tests/test_datatypes.py:403."""
    c_j, c_t = both(lambda dt: dt.type_contiguous(2, np.float32).commit())
    for unpack in (c_j.unpack_jax, c_t.unpack_torch):
        with pytest.raises(TypeError, match="payload dtype"):
            unpack(np.array([7, 8], np.int32), np.zeros(4, np.float32))
        with pytest.raises(ValueError, match="payload has"):
            unpack(np.float32(5.0), np.zeros(4, np.float32))


def test_host_path_is_the_reference_copy():
    """The numpy host path is copied unchanged: same maps, same bytes."""
    t_j, t_t = both(lambda dt: dt.type_create_struct(
        [1, 2], [0, 8], [np.int32, np.float32]).commit())
    np.testing.assert_array_equal(t_t.indices, t_j.indices)
    buf = np.arange(16, dtype=np.uint8)
    assert tdt.pack_external(buf, t_t) == jdt.pack_external(buf, t_j)
