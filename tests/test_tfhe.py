"""TFHE primitive tests: encrypt/decrypt, blind rotate, keyswitch, full PBS.

Uses TEST_PARAMS (tiny, insecure) so the O(n * N^2) reference-exact path runs
in seconds on a CPU.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from dct_cryptonets.fhe import torus as T
from dct_cryptonets.fhe.params import TEST_PARAMS, NoiseModel, params_for_precision
from dct_cryptonets.fhe import keys as K
from dct_cryptonets.fhe import pbs as P

U64 = np.uint64
PAR = TEST_PARAMS


@pytest.fixture(scope="module")
def material():
    ck = K.keygen(PAR, seed=0)
    sk = K.make_server_keys(ck, seed=1)
    dsk = P.preprocess_server_keys(sk)
    return ck, sk, dsk


def encode(vals, bits):
    """Integer -> torus with one padding bit: v * 2^(64-bits-1)."""
    return (np.asarray(vals, U64) << U64(64 - bits - 1))


def decode(phases, bits):
    """Torus -> integer round."""
    shift = U64(64 - bits - 1)
    half = U64(1) << (shift - U64(1))
    with np.errstate(over="ignore"):
        return ((phases + half) >> shift) & U64((1 << (bits + 1)) - 1)


def test_lwe_roundtrip(material):
    ck, _, _ = material
    rng = np.random.default_rng(3)
    msgs = rng.integers(0, 16, 50)
    ct = K.encrypt_lwe(ck, encode(msgs, 4), rng)
    dec = decode(K.decrypt_lwe(ck, ct), 4)
    np.testing.assert_array_equal(dec, msgs)


def test_glwe_roundtrip(material):
    ck, _, _ = material
    rng = np.random.default_rng(4)
    ct = K.encrypt_glwe_zero(ck, rng)
    msg = encode(rng.integers(0, 16, PAR.poly_size), 4)
    with np.errstate(over="ignore"):
        ct[-1] += msg
    phase = K.decrypt_glwe(ck, ct)
    np.testing.assert_array_equal(decode(phase, 4), decode(msg, 4))


def test_external_product_selects(material):
    """GGSW(bit) x GLWE == bit * GLWE message (the CMUX building block)."""
    ck, sk, dsk = material
    rng = np.random.default_rng(5)
    k, N = PAR.glwe_dim, PAR.poly_size

    msg_int = rng.integers(0, 16, N)
    glwe = K.encrypt_glwe_zero(ck, rng)
    with np.errstate(over="ignore"):
        glwe[-1] += encode(msg_int, 4)

    pt = (PAR.pbs_base_log, PAR.pbs_levels, k, N)
    diff = T.from_u64(glwe[None])                     # (1, k+1, N)
    for i, bit in [(0, int(ck.lwe_key[0])), (1, int(ck.lwe_key[1]))]:
        out = P.external_product_step(diff, dsk.bsk_bytes[i], pt, 0)
        res = T.to_u64(out)[0]
        phase = K.decrypt_glwe(ck, res)
        got = decode(phase, 4)
        want = decode(encode(msg_int, 4), 4) if bit else np.zeros(N, U64)
        np.testing.assert_array_equal(got, want, err_msg=f"bit={bit}")


def test_sample_extract(material):
    ck, _, _ = material
    rng = np.random.default_rng(6)
    msg_int = rng.integers(0, 16, PAR.poly_size)
    glwe = K.encrypt_glwe_zero(ck, rng)
    with np.errstate(over="ignore"):
        glwe[-1] += encode(msg_int, 4)
    ext = P.sample_extract(T.from_u64(glwe[None]), PAR)
    ct = T.to_u64(ext)[0]                              # (kN+1,)
    phase = K.decrypt_lwe(ck, ct, key=ck.big_lwe_key)
    assert decode(phase, 4) == msg_int[0]


def test_keyswitch(material):
    ck, _, dsk = material
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 16, 20)
    big_ct = K.encrypt_lwe(ck, encode(msgs, 4), rng, key=ck.big_lwe_key,
                           noise_log2=PAR.glwe_noise_log2)
    out = P.key_switch(T.from_u64(big_ct), dsk.ksk_bytes, PAR)
    dec = decode(K.decrypt_lwe(ck, T.to_u64(out)), 4)
    np.testing.assert_array_equal(dec, msgs)


def test_full_pbs_identity_table(material):
    """Bootstrap (KS->MS->BR->SE on big-LWE) with the identity TLU."""
    ck, _, dsk = material
    rng = np.random.default_rng(8)
    bits = 3                                           # 8-entry table
    msgs = rng.integers(0, 2 ** bits, 16)
    ct = K.encrypt_lwe(ck, encode(msgs, bits), rng, key=ck.big_lwe_key,
                       noise_log2=PAR.glwe_noise_log2)
    tables = jnp.tile(jnp.arange(2 ** bits, dtype=jnp.int32), (16, 1))
    out = P.bootstrap(T.from_u64(ct), tables, dsk, PAR,
                      out_delta_log2=64 - bits - 1)
    dec = decode(K.decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key), bits)
    np.testing.assert_array_equal(dec, msgs)


def test_full_pbs_arbitrary_table(material):
    """Bootstrap with a random per-sample TLU; output stays big-LWE."""
    ck, _, dsk = material
    rng = np.random.default_rng(9)
    bits = 3
    M = 12
    msgs = rng.integers(0, 2 ** bits, M)
    tbl = rng.integers(0, 2 ** bits, (M, 2 ** bits))
    ct = K.encrypt_lwe(ck, encode(msgs, bits), rng, key=ck.big_lwe_key,
                       noise_log2=PAR.glwe_noise_log2)
    out = P.bootstrap(T.from_u64(ct), jnp.asarray(tbl, jnp.int32), dsk, PAR,
                      out_delta_log2=64 - bits - 1)
    assert out.hi.shape == (M, PAR.big_lwe_dim + 1)
    dec = decode(K.decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key), bits)
    np.testing.assert_array_equal(dec, tbl[np.arange(M), msgs])


def test_noise_model_presets():
    """Production presets must meet p_error <= 0.02 per PBS at their rated
    precision, per the analytic noise model."""
    for bits in [4, 5, 6, 7]:
        p = params_for_precision(bits)
        nm = NoiseModel(p)
        perr = nm.pbs_error_probability(bits, input_variance=nm.var_pbs_output())
        assert perr < 0.02, (bits, perr)
