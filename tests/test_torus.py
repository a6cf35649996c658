"""Limb-pair torus arithmetic vs numpy uint64 ground truth."""
import numpy as np
import jax.numpy as jnp

from dct_cryptonets.fhe import torus as T


RNG = np.random.default_rng(7)


def rand_u64(shape):
    x = RNG.integers(0, 1 << 63, shape, dtype=np.int64).astype(np.uint64)
    return (x << np.uint64(1)) | RNG.integers(0, 2, shape).astype(np.uint64)


def test_roundtrip():
    x = rand_u64((17,))
    np.testing.assert_array_equal(T.to_u64(T.from_u64(x)), x)


def test_add_sub_neg():
    a, b = rand_u64((100,)), rand_u64((100,))
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(T.to_u64(T.add(T.from_u64(a), T.from_u64(b))), a + b)
        np.testing.assert_array_equal(T.to_u64(T.sub(T.from_u64(a), T.from_u64(b))), a - b)
        np.testing.assert_array_equal(T.to_u64(T.neg(T.from_u64(a))), np.uint64(0) - a)


def test_scalar_mul_signed():
    a = rand_u64((64,))
    m = RNG.integers(-(2 ** 31), 2 ** 31, (64,)).astype(np.int32)
    got = T.to_u64(T.scalar_mul(T.from_u64(a), jnp.asarray(m)))
    with np.errstate(over="ignore"):
        want = a * m.astype(np.int64).astype(np.uint64)  # m mod 2^64
    np.testing.assert_array_equal(got, want)


def test_shift_left_and_from_i32():
    a = rand_u64((8,))
    for k in [0, 1, 13, 31, 32, 33, 47, 63]:
        with np.errstate(over="ignore"):
            want = a << np.uint64(k)
        np.testing.assert_array_equal(T.to_u64(T.shift_left(T.from_u64(a), k)), want, err_msg=f"k={k}")
    v = RNG.integers(-1000, 1000, (50,)).astype(np.int32)
    for k in [0, 20, 40, 56]:
        got = T.to_u64(T.from_i32_shifted(jnp.asarray(v), k))
        with np.errstate(over="ignore"):
            want = v.astype(np.int64).astype(np.uint64) << np.uint64(k)
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


def test_round_shift_right():
    a = rand_u64((200,))
    for k in [32, 40, 52, 56]:
        got = np.asarray(T.round_shift_right(T.from_u64(a), k))
        half = np.uint64(1) << np.uint64(k - 1)
        with np.errstate(over="ignore"):
            want = ((a + half) >> np.uint64(k)).astype(np.uint32)
            # wrap of the add is intentional (values near 2^64 round to 0)
            want = (((a + half) >> np.uint64(k)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


def test_decompose_recompose_close():
    """Recomposition must match the input up to the rounding remainder."""
    a = rand_u64((500,))
    for blog, levels in [(15, 2), (23, 1), (4, 5), (3, 6)]:
        d = T.decompose(T.from_u64(a), blog, levels)
        assert d.shape == (levels, 500)
        B = 1 << blog
        assert int(jnp.max(jnp.abs(d))) <= B // 2
        rec = T.to_u64(T.recompose(d, blog))
        with np.errstate(over="ignore"):
            err = (rec - a).astype(np.int64)
        rem = 1 << (64 - blog * levels)
        assert np.abs(err).max() <= rem // 2, (blog, levels, np.abs(err).max(), rem)


def test_signed_byte_split():
    from dct_cryptonets.fhe.pbs import signed_byte_split
    d = RNG.integers(-(2 ** 22), 2 ** 22, (1000,)).astype(np.int32)
    b = np.asarray(signed_byte_split(jnp.asarray(d), 3)).astype(np.int64)
    rec = b[0] + b[1] * 256 + b[2] * 256 ** 2
    np.testing.assert_array_equal(rec, d)
