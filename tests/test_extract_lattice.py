"""Multi-mask-polynomial (k>1) engine paths, the small extraction lattice,
and the cross skip.

The exact-rounding extraction bootstraps dominate encrypted-inference cost
(~3.8 aux PBS per main PBS on the flagship circuit), so they run on a small
GLWE geometry (params.EXTRACT_PRESETS: k=4/N=256 or k=2/N=512 at the same
k*N security as k=1/N=1024).  These tests pin the k>1 correctness of the
blind rotate, the cross-key extraction pipeline, and the audit-gated cross skip
(pbs.py ``cross``) the throughput mode relies on.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from dct_cryptonets.fhe import keys as K
from dct_cryptonets.fhe import pbs as P
from dct_cryptonets.fhe import torus as T
from pbs_reference import blind_rotate_ref
from dct_cryptonets.fhe.params import (EXTRACT_PRESETS, NoiseModel,
                                           ExactRoundingConfig, TEST_PARAMS,
                                           TEST_PARAMS_K2,
                                           default_exact_rounding,
                                           params_for_precision)

U64 = np.uint64


@pytest.fixture(scope="module")
def material_k2():
    ck = K.keygen(TEST_PARAMS_K2, seed=7)
    sk = K.make_server_keys(ck, seed=8)
    return ck, P.preprocess_server_keys(sk)


def test_full_pbs_k2_decrypts_table(material_k2):
    """PBS correctness with two GLWE mask polynomials."""
    ck, dsk = material_k2
    par = TEST_PARAMS_K2
    rng = np.random.default_rng(31)
    M, bits = 16, 3
    msgs = rng.integers(0, 2 ** bits, M)
    table = rng.integers(-4, 4, (M, 2 ** bits)).astype(np.int32)
    ct = K.encrypt_lwe(ck, msgs.astype(U64) << U64(64 - bits - 1), rng,
                       key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2)
    out = P.bootstrap(T.from_u64(ct), jnp.asarray(table), dsk, par, 60)
    phase = K.decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
    got = np.round(phase.astype(np.int64).astype(np.float64) / 2.0 ** 60)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  table[np.arange(M), msgs])


@pytest.mark.parametrize("drop,cross", [(0, 0), (2, 0), (0, 1), (2, 1)])
def test_engines_bit_exact_k2(material_k2, drop, cross):
    """The blind rotate agrees bit-for-bit at k=2 with the plain numpy
    reference (tests/pbs_reference.py) for every (drop_limbs, cross)
    combination."""
    ck, dsk = material_k2
    par = TEST_PARAMS_K2
    rng = np.random.default_rng(41 + drop + 10 * cross)
    M = 3
    test = rng.integers(0, 2 ** 63, (M, par.poly_size), dtype=np.uint64)
    ct_a = rng.integers(0, 2 * par.poly_size, (M, par.lwe_dim))
    ct_b = rng.integers(0, 2 * par.poly_size, M)
    got = P.blind_rotate(T.from_u64(test), jnp.asarray(ct_a, jnp.uint32),
                         jnp.asarray(ct_b, jnp.uint32), dsk.bsk_bytes, par,
                         drop, cross)
    want = blind_rotate_ref(test, ct_a, ct_b, np.asarray(dsk.bsk_bytes),
                            par, drop, cross)
    np.testing.assert_array_equal(T.to_u64(got), want)


def test_cross_skip_correct_at_test_noise(material_k2):
    """cross=1 drops only below-noise-floor products: messages decrypt."""
    ck, dsk = material_k2
    par = TEST_PARAMS_K2
    rng = np.random.default_rng(53)
    M, bits = 16, 3
    msgs = rng.integers(0, 2 ** bits, M)
    table = np.broadcast_to(np.arange(2 ** bits, dtype=np.int32),
                            (M, 2 ** bits)).copy()
    ct = K.encrypt_lwe(ck, msgs.astype(U64) << U64(64 - bits - 1), rng,
                       key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2)
    out = P.bootstrap(T.from_u64(ct), jnp.asarray(table), dsk, par, 60,
                      drop_limbs=0, cross=1)
    phase = K.decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
    got = np.round(phase.astype(np.int64).astype(np.float64) / 2.0 ** 60)
    np.testing.assert_array_equal(got.astype(np.int64), msgs)


def test_clear_low_bits_with_k2_aux():
    """Cross-key extraction: main k=1 set, aux k=2 set (the production
    shape — EXTRACT_PRESETS trade poly size for mask polynomials)."""
    main_ck = K.keygen(TEST_PARAMS, seed=3)
    cfg = ExactRoundingConfig(TEST_PARAMS_K2)
    ak = K.make_aux_server_keys(main_ck, cfg.aux, seed=4,
                                back_base_log=cfg.back_base_log,
                                back_levels=cfg.back_levels)
    dak = P.preprocess_aux_keys(ak)
    n_in, shift = 11, 4
    rng = np.random.default_rng(9)
    v = rng.integers(0, 1 << n_in, 32, dtype=np.int64)
    delta_log2 = 63 - n_in
    with np.errstate(over="ignore"):
        mu = v.astype(U64) << U64(delta_log2)
    ct = K.encrypt_lwe(main_ck, mu, rng, key=main_ck.big_lwe_key,
                       noise_log2=TEST_PARAMS.glwe_noise_log2)
    out = P.clear_low_bits(T.from_u64(ct), dak, cfg.aux, n_in, shift,
                           cfg.back_base_log, cfg.back_levels)
    phase = K.decrypt_lwe(main_ck, T.to_u64(out), key=main_ck.big_lwe_key)
    got = np.round(phase.astype(np.float64) / 2.0 ** delta_log2).astype(
        np.int64) % (1 << (n_in + 1))
    want = (v - (v % (1 << shift))) % (1 << (n_in + 1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(EXTRACT_PRESETS))
def test_extract_presets_feasible(name):
    """Every extraction preset passes the quarter-torus feasibility check
    for every production main set, and injects per-bit noise far below the
    tightest main decision margin."""
    aux = EXTRACT_PRESETS[name]
    assert aux.glwe_dim * aux.poly_size == 1024  # security ladder invariant
    # the fast set's noisier small key is only rated for mains up to
    # kN = 2048 (presets 5/6, incl. the flagship); larger mains' forward
    # keyswitch amplifies its fresh noise past the slip threshold and
    # default_exact_rounding falls back to k2n512 automatically
    mains = (5, 6) if name == "k2n512f" else (5, 6, 7, 8)
    for bits in mains:
        main = params_for_precision(bits)
        cfg = default_exact_rounding(main, extract=name)
        assert cfg.aux is not aux or cfg.aux is aux  # construction succeeded
        # per-extracted-bit injection (BR output + back keyswitch) must sit
        # well under the main PBS decision margin even x6 bits
        nm = NoiseModel(aux)
        margin = 2.0 ** (62 - main.message_bits)
        sigma6 = (6 * (nm.var_blind_rotate()
                       + nm.var_drop_limbs(3))) ** 0.5
        # /4: a loose sanity bound — the circuit audit enforces the exact
        # per-decision budget (and lowers the aux knob where needed)
        assert sigma6 < margin / 4.0


def test_audit_uses_knob_ladder():
    """The audit hands out (drop, cross) pairs and caps p_error on a
    synthetic two-TLU circuit with a heavy conv between them."""
    from dct_cryptonets.fhe.circuit import (Circuit, Conv, Output,
                                                QuantIn, Tlu, TluSpec)
    from dct_cryptonets.fhe.noise_audit import audit_circuit

    par = params_for_precision(6)
    rng = np.random.default_rng(5)
    w = rng.integers(-7, 8, (3, 3, 4, 4)).astype(np.int32)
    table = np.zeros((4, 64), np.int32)
    ops = [
        QuantIn(1.0, 5, 10, "x0"),
        Conv("x0", w, 1, 1, "acc1"),
        Tlu("acc1", TluSpec(6, 3, 10), table, "t1"),
        Conv("t1", w, 1, 1, "acc2"),
        Tlu("acc2", TluSpec(6, 3, 10), table, "t2"),
        Output("t2", 1.0),
    ]
    shapes = {"x0": (8, 8, 4), "acc1": (8, 8, 4), "t1": (8, 8, 4),
              "acc2": (8, 8, 4), "t2": (8, 8, 4)}
    circ = Circuit(ops, (8, 8, 4), {"x0": 5, "acc1": 10, "t1": 10,
                                    "acc2": 10, "t2": 10},
                   {"shapes": shapes})
    res = audit_circuit(circ, par, p_error=0.015)
    assert res.max_p_error <= 0.015
    for r in res.reports:
        assert 0 <= r.drop_limbs <= 4 and r.cross in (0, 1)
        # audit accessor parity
        assert res.drop_for(r.acc) == r.drop_limbs
        assert res.cross_for(r.acc) == r.cross


def test_clear_low_bits_ks_drop_still_correct():
    """Truncated-KSK extraction at TEST noise: dropped KSK limbs add noise
    far below the test margins, so the cleared value is unchanged."""
    main_ck = K.keygen(TEST_PARAMS, seed=3)
    cfg = ExactRoundingConfig(TEST_PARAMS_K2)
    ak = K.make_aux_server_keys(main_ck, cfg.aux, seed=4,
                                back_base_log=cfg.back_base_log,
                                back_levels=cfg.back_levels)
    dak = P.preprocess_aux_keys(ak)
    n_in, shift = 10, 3
    rng = np.random.default_rng(17)
    v = rng.integers(0, 1 << n_in, 32, dtype=np.int64)
    with np.errstate(over="ignore"):
        mu = v.astype(U64) << U64(63 - n_in)
    ct = K.encrypt_lwe(main_ck, mu, rng, key=main_ck.big_lwe_key,
                       noise_log2=TEST_PARAMS.glwe_noise_log2)
    out = P.clear_low_bits(T.from_u64(ct), dak, cfg.aux, n_in, shift,
                           cfg.back_base_log, cfg.back_levels,
                           fwd_ks_drop=2, back_ks_drop=2)
    phase = K.decrypt_lwe(main_ck, T.to_u64(out), key=main_ck.big_lwe_key)
    got = np.round(phase.astype(np.float64) / 2.0 ** (63 - n_in)).astype(
        np.int64) % (1 << (n_in + 1))
    want = (v - (v % (1 << shift))) % (1 << (n_in + 1))
    np.testing.assert_array_equal(got, want)


def test_audit_reports_ks_drops():
    """The audit chooses truncated-KSK limb drops for the extraction hops
    and they respect the variance caps of NoiseModel.var_ks_drop."""
    from dct_cryptonets.fhe.circuit import (Circuit, Conv, Output,
                                                QuantIn, Tlu, TluSpec)
    from dct_cryptonets.fhe.noise_audit import audit_circuit

    par = params_for_precision(6)
    rng = np.random.default_rng(5)
    w = rng.integers(-7, 8, (3, 3, 4, 4)).astype(np.int32)
    table = np.zeros((4, 64), np.int32)
    ops = [QuantIn(1.0, 5, 10, "x0"), Conv("x0", w, 1, 1, "acc1"),
           Tlu("acc1", TluSpec(6, 3, 10), table, "t1"), Output("t1", 1.0)]
    shapes = {"x0": (8, 8, 4), "acc1": (8, 8, 4), "t1": (8, 8, 4)}
    circ = Circuit(ops, (8, 8, 4), {"x0": 5, "acc1": 10, "t1": 10},
                   {"shapes": shapes})
    res = audit_circuit(circ, par, p_error=0.015)
    assert res.max_p_error <= 0.015
    # production extraction lattice affords deep KSK truncation
    assert res.aux_fwd_ks_drop >= 4
    assert res.aux_back_ks_drop >= 2
    cfg_aux = res  # drops recorded on the result for the runtime to use
    assert cfg_aux.aux_back_ks_drop <= 6 and cfg_aux.aux_fwd_ks_drop <= 6
