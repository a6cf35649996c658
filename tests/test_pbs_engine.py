"""The blind-rotate engine and the levelled integer convs against plain
references: the numpy blind rotate of ``pbs_reference`` and numpy int64
convolutions.  These are the paths the GPU runs; the CPU runs the same
code."""
import numpy as np
import jax.numpy as jnp
import pytest

from pbs_reference import blind_rotate_ref
from dct_cryptonets.fhe import keys as K
from dct_cryptonets.fhe import pbs as P
from dct_cryptonets.fhe import torus as T
from dct_cryptonets.fhe.circuit import _conv_int, _pool_sum
from dct_cryptonets.fhe.params import TEST_PARAMS as PAR
from dct_cryptonets.fhe.runtime import _conv_limbs

U64 = np.uint64


@pytest.fixture(scope="module")
def material():
    ck = K.keygen(PAR, seed=0)
    sk = K.make_server_keys(ck, seed=1)
    return ck, P.preprocess_server_keys(sk)


def conv_int64(x, w, stride, padding):
    """NHWC x HWIO integer convolution in numpy int64."""
    kh, kw, _, co = w.shape
    xp = np.pad(x, ((0, 0), (padding, padding), (padding, padding), (0, 0)))
    oh = (x.shape[1] + 2 * padding - kh) // stride + 1
    ow = (x.shape[2] + 2 * padding - kw) // stride + 1
    out = np.zeros((x.shape[0], oh, ow, co), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            win = xp[:, dy:dy + (oh - 1) * stride + 1:stride,
                     dx:dx + (ow - 1) * stride + 1:stride]
            out += np.einsum("bhwc,co->bhwo", win, w[dy, dx])
    return out


@pytest.mark.parametrize("drop", [0, 2])
def test_blind_rotate_matches_reference(material, drop):
    """Bit-exact against the numpy reference with the cross skip on."""
    _, dsk = material
    rng = np.random.default_rng(21 + drop)
    M = 4
    test = rng.integers(0, 2 ** 63, (M, PAR.poly_size), dtype=np.uint64)
    ct_a = rng.integers(0, 2 * PAR.poly_size, (M, PAR.lwe_dim))
    ct_b = rng.integers(0, 2 * PAR.poly_size, M)
    got = P.blind_rotate(T.from_u64(test), jnp.asarray(ct_a, jnp.uint32),
                         jnp.asarray(ct_b, jnp.uint32), dsk.bsk_bytes, PAR,
                         drop, 1)
    want = blind_rotate_ref(test, ct_a, ct_b, np.asarray(dsk.bsk_bytes),
                            PAR, drop, 1)
    np.testing.assert_array_equal(T.to_u64(got), want)


def test_unaligned_batch(material):
    """An M=13 batch (a pbs_batch remainder chunk) decrypts to its table
    entries, and each sample's output does not depend on the batch it
    rides in."""
    ck, dsk = material
    rng = np.random.default_rng(77)
    M, bits = 13, 3
    msgs = rng.integers(0, 2 ** bits, M)
    ct = K.encrypt_lwe(ck, msgs.astype(U64) << U64(64 - bits - 1), rng,
                       key=ck.big_lwe_key, noise_log2=PAR.glwe_noise_log2)
    tables = rng.integers(-4, 4, (M, 2 ** bits)).astype(np.int32)
    out = P.bootstrap(T.from_u64(ct), jnp.asarray(tables), dsk, PAR, 60)
    assert out.hi.shape == (M, PAR.big_lwe_dim + 1)
    phase = K.decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
    got = np.round(phase.astype(np.int64).astype(np.float64) / 2.0 ** 60)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  tables[np.arange(M), msgs])
    head = P.bootstrap(T.from_u64(ct[:8]), jnp.asarray(tables[:8]), dsk,
                       PAR, 60)
    np.testing.assert_array_equal(T.to_u64(head), T.to_u64(out)[:8])


@pytest.mark.parametrize("stride,padding,wmax", [(1, 1, 127), (2, 1, 3000)])
def test_conv_limbs_matches_int64(stride, padding, wmax):
    """The levelled ciphertext conv equals an int64 conv mod 2^64, with
    one-byte and (wmax > 127) two-byte weights."""
    rng = np.random.default_rng(stride)
    B, n1, H, W, C, co = 1, 3, 6, 6, 5, 4
    ct = rng.integers(0, 2 ** 64, (B, n1, H, W, C), dtype=np.uint64)
    w = rng.integers(-wmax, wmax + 1, (3, 3, C, co)).astype(np.int32)
    got = T.to_u64(_conv_limbs(T.from_u64(ct), w, stride, padding))
    x = np.moveaxis(ct, 1, 0).reshape(B * n1, H, W, C).view(np.int64)
    with np.errstate(over="ignore"):
        want = conv_int64(x, w.astype(np.int64), stride, padding)
    want = want.view(U64).reshape(n1, B, *want.shape[1:])
    np.testing.assert_array_equal(got, np.moveaxis(want, 0, 1))


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_simulate_conv_matches_int64(stride, padding):
    """The simulator's integer conv at a 64-channel width."""
    rng = np.random.default_rng(10 + stride)
    x = rng.integers(-127, 128, (2, 8, 8, 64))
    w = rng.integers(-127, 128, (3, 3, 64, 64))
    got = np.asarray(_conv_int(jnp.asarray(x, jnp.int32),
                               w.astype(np.int32), stride, padding))
    np.testing.assert_array_equal(got, conv_int64(x, w, stride, padding))


def test_simulate_pool_matches_int64():
    rng = np.random.default_rng(3)
    x = rng.integers(-2 ** 15, 2 ** 15, (2, 8, 8, 16))
    got = np.asarray(_pool_sum(jnp.asarray(x, jnp.int32), 4))
    want = x.reshape(2, 2, 4, 2, 4, 16).sum(axis=(2, 4))
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_bootstrap_on_card_matches_cpu(material, gpu_device):
    """The card's GEMM engine gives the CPU's ciphertexts bit for bit."""
    import jax
    ck, dsk = material
    rng = np.random.default_rng(5)
    M, bits = 13, 3
    msgs = rng.integers(0, 2 ** bits, M)
    ct = T.from_u64(K.encrypt_lwe(ck, msgs.astype(U64) << U64(64 - bits - 1),
                                  rng, key=ck.big_lwe_key,
                                  noise_log2=PAR.glwe_noise_log2))
    tables = jnp.asarray(rng.integers(-4, 4, (M, 2 ** bits)), jnp.int32)
    outs = [T.to_u64(P.bootstrap(*jax.device_put((ct, tables, dsk), dev),
                                 PAR, 60, 2, 1))
            for dev in (gpu_device, jax.devices("cpu")[0])]
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.gpu
def test_conv_limbs_on_card_matches_cpu(gpu_device):
    """A 1x1 conv over 3 channels (contraction 3, the width XLA:GPU got
    wrong unpadded) on the card against the CPU."""
    import jax
    rng = np.random.default_rng(9)
    ct = T.from_u64(rng.integers(0, 2 ** 64, (2, 5, 2, 2, 3),
                                 dtype=np.uint64))
    w = rng.integers(-127, 128, (1, 1, 3, 4)).astype(np.int32)
    outs = [T.to_u64(_conv_limbs(jax.device_put(ct, dev), w, 1, 0))
            for dev in (gpu_device, jax.devices("cpu")[0])]
    np.testing.assert_array_equal(outs[0], outs[1])
