"""Exact-rounding mode: LSB extraction clears dropped accumulator bits.

Concrete's default ``rounding_threshold_bits`` method is "exact" (the
reference compiles with it, homomorphic_eval.py:276-285): before a rounded
TLU's table lookup the low ``shift`` bits of the accumulator are cleared
with auxiliary bootstraps so the PBS phase sits exactly on window centers.
These tests validate the primitive (``pbs.clear_low_bits``) against plain
integer arithmetic and the end-to-end contract execute == simulate in both
rounding modes.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from dct_cryptonets.fhe import torus as T
from dct_cryptonets.fhe.keys import (encrypt_lwe, decrypt_lwe, keygen,
                                         make_aux_server_keys)
from dct_cryptonets.fhe.params import (TEST_PARAMS,
                                           default_exact_rounding)
from dct_cryptonets.fhe.pbs import clear_low_bits, preprocess_aux_keys

U64 = np.uint64


@pytest.fixture(scope="module")
def aux_setup():
    ck = keygen(TEST_PARAMS, seed=3)
    cfg = default_exact_rounding(TEST_PARAMS)
    assert cfg.aux is TEST_PARAMS  # tiny main sets reuse themselves
    ak = make_aux_server_keys(ck, cfg.aux, seed=4,
                              back_base_log=cfg.back_base_log,
                              back_levels=cfg.back_levels)
    return ck, cfg, preprocess_aux_keys(ak)


@pytest.mark.parametrize("shift", [1, 3, 5, 7])
def test_clear_low_bits_matches_integer_arithmetic(aux_setup, shift):
    ck, cfg, dak = aux_setup
    n_in = 11
    rng = np.random.default_rng(shift)
    # nonneg values as produced by the recentered TLU input (runtime adds
    # +2^(n_in-1) before clearing)
    v = rng.integers(0, 1 << n_in, 64, dtype=np.int64)
    delta_log2 = 63 - n_in
    with np.errstate(over="ignore"):
        mu = v.astype(U64) << U64(delta_log2)
    ct = encrypt_lwe(ck, mu, rng, key=ck.big_lwe_key,
                     noise_log2=ck.params.glwe_noise_log2)
    ctt = T.from_u64(ct)                              # (M, kN+1)
    out = clear_low_bits(ctt, dak, cfg.aux, n_in, shift,
                         cfg.back_base_log, cfg.back_levels)
    phase = decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
    got = np.round(phase.astype(np.float64) / 2.0 ** delta_log2).astype(
        np.int64) % (1 << (n_in + 1))
    want = (v - (v % (1 << shift))) % (1 << (n_in + 1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift,keep", [(3, 1), (5, 2), (5, 4), (7, 3)])
def test_partial_clearing_matches_integer_arithmetic(aux_setup, shift, keep):
    """keep_low > 0 clears only bits [keep, shift): the low bits ride
    through as a bounded offset (the audit's partial-clearing mode) and
    each extracted bit's re-centered sign offset must still read the right
    bit despite the uncleared junk below it."""
    ck, cfg, dak = aux_setup
    n_in = 11
    rng = np.random.default_rng(10 * shift + keep)
    v = rng.integers(0, 1 << n_in, 64, dtype=np.int64)
    delta_log2 = 63 - n_in
    with np.errstate(over="ignore"):
        mu = v.astype(U64) << U64(delta_log2)
    ct = encrypt_lwe(ck, mu, rng, key=ck.big_lwe_key,
                     noise_log2=ck.params.glwe_noise_log2)
    out = clear_low_bits(T.from_u64(ct), dak, cfg.aux, n_in, shift,
                         cfg.back_base_log, cfg.back_levels, keep_low=keep)
    phase = decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
    got = np.round(phase.astype(np.float64) / 2.0 ** delta_log2).astype(
        np.int64) % (1 << (n_in + 1))
    want = (v - (v % (1 << shift)) + (v % (1 << keep))) % (1 << (n_in + 1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_execute_matches_simulate_both_rounding_methods():
    """Tiny net, heavy rounding: exact and approximate modes both match the
    simulator at test noise (approximate only because noise << LSB here;
    at production noise only exact keeps the bit-exact contract)."""
    import jax
    from dct_cryptonets.models import init_model, calibrate_scales
    from dct_cryptonets.models.resnet import ModelSpec, forward
    from dct_cryptonets.models.topology import StemSpec
    from dct_cryptonets.fhe.runtime import compile_qat_model

    tiny = ModelSpec(
        name="tinyqat", block_counts=(1,), widths=(4,), in_channels=3,
        img_size=4, num_classes=4, bit_width=3, quantized=True,
        stem_override=StemSpec(1, 1, 0, None, None, 4, relu1=True),
    )
    params, state = init_model(jax.random.key(0), tiny)
    x = jax.random.normal(jax.random.key(1), (8, 4, 4, 3))
    for _ in range(2):
        _, _, state = forward(params, state, x, tiny, train=True)
    params = calibrate_scales(params, state, x, tiny)

    xq = np.clip(np.random.default_rng(3).normal(0, 0.7, (1, 4, 4, 3)),
                 -2, 2).astype(np.float32)
    for method in ("exact", "approximate"):
        module = compile_qat_model(
            params, state, tiny, n_bits=3,
            rounding_threshold_bits={"n_bits": 3, "method": method},
            calib_absmax=2.0, tfhe_params=TEST_PARAMS, pbs_batch=512)
        module.keygen(seed=5)
        assert (module.aux_keys is not None) == (method == "exact")
        feats_sim = module.forward(xq, fhe="simulate")
        feats_exe = module.forward(xq, fhe="execute")
        np.testing.assert_array_equal(feats_exe, feats_sim)
        if method == "exact":
            assert module.stats.get("aux_pbs_executed", 0) > 0


def test_audit_partial_clearing_centering_order():
    """Single-TLU circuit with an IDENTITY table (adjacent entries always
    differ) over accumulator values covering every residue mod 2^shift —
    the sharp version of the centering-order regression (ADVICE r3 high).
    Subtracting the 2^(keep-1)*Delta centering constant BEFORE
    clear_low_bits borrows across the cleared bit field for residues
    < 2^(keep-1): the main PBS then reads one window low, deterministically.
    On a relu-ish table such misreads can land on plateaus and hide; the
    identity table turns every misread into an output mismatch."""
    from dct_cryptonets.fhe.circuit import (Circuit, Output, QuantIn,
                                                Tlu, TluSpec)
    from dct_cryptonets.fhe.runtime import CompiledModule

    r, shift = 4, 3
    n_in = r + shift
    table = (np.arange(1 << r, dtype=np.int32) - (1 << (r - 1)))[None]
    circ = Circuit(
        ops=[QuantIn(scale=1.0, bits=n_in, n=n_in, out="x0"),
             Tlu("x0", TluSpec(in_bits=r, shift=shift, out_n=r), table, "y"),
             Output("y", scale=1.0)],
        input_shape=(1, 1, 1),
        n_budget={"x0": n_in, "y": r},
        meta={"shapes": {"x0": (1, 1, 1), "y": (1, 1, 1)}},
    )
    # acc in [-64, 59]: index stays in [0, 15] (no clipping divergence),
    # all residues mod 2^shift covered many times
    acc = np.arange(-64, 60, dtype=np.float32).reshape(-1, 1, 1, 1)
    module = CompiledModule(circ, TEST_PARAMS, pbs_batch=512,
                            rounding_method="exact", drop_policy="audit")
    module.keygen(seed=7)
    audit = module.run_audit()
    for rep in audit.reports:
        rep.drop_limbs = rep.cross = 0
        rep.keep_low = 2          # < shift: the clear+center path runs
    module.aux_drop_limbs = module.aux_cross = 0
    module.aux_fwd_ks_drop = module.aux_back_ks_drop = 0
    feats_sim = module.forward(acc, fhe="simulate")
    feats_exe = module.forward(acc, fhe="execute")
    np.testing.assert_array_equal(feats_exe, feats_sim)


@pytest.mark.slow
def test_execute_matches_simulate_audit_partial_clearing():
    """drop_policy='audit' with keep_low > 0 and all limb drops forced to
    zero must stay bit-exact vs the simulator.  Regression for the
    centering-order bug: subtracting the 2^(keep-1)*Delta centering
    constant BEFORE clear_low_bits borrows across the cleared bit field
    whenever (v + 2^(shift-1)) mod 2^keep < 2^(keep-1), so the main PBS
    deterministically read one window low on a 2^(keep-1)/2^shift fraction
    of accumulator values (ADVICE r3 high)."""
    import jax
    from dct_cryptonets.models import init_model, calibrate_scales
    from dct_cryptonets.models.resnet import ModelSpec, forward
    from dct_cryptonets.models.topology import StemSpec
    from dct_cryptonets.fhe.runtime import compile_qat_model

    tiny = ModelSpec(
        name="tinyqat", block_counts=(1,), widths=(4,), in_channels=3,
        img_size=4, num_classes=4, bit_width=3, quantized=True,
        stem_override=StemSpec(1, 1, 0, None, None, 4, relu1=True),
    )
    params, state = init_model(jax.random.key(0), tiny)
    x = jax.random.normal(jax.random.key(1), (8, 4, 4, 3))
    for _ in range(2):
        _, _, state = forward(params, state, x, tiny, train=True)
    params = calibrate_scales(params, state, x, tiny)

    xq = np.clip(np.random.default_rng(3).normal(0, 0.7, (4, 4, 4, 3)),
                 -2, 2).astype(np.float32)
    module = compile_qat_model(
        params, state, tiny, n_bits=3, rounding_threshold_bits=3,
        calib_absmax=2.0, tfhe_params=TEST_PARAMS, pbs_batch=512,
        drop_policy="audit")
    module.keygen(seed=5)
    # force the audited knobs to the bit-exact contract (no dropped limbs,
    # noise << LSB at TEST_PARAMS) but with partial clearing ON everywhere
    # it applies — the exact configuration the bug corrupted.
    audit = module.run_audit()
    forced = 0
    for rep in audit.reports:
        rep.drop_limbs = rep.cross = 0
        rep.keep_low = min(2, rep.shift)
        forced += rep.keep_low > 0
    assert forced > 0, "test net must have at least one rounded TLU"
    module.aux_drop_limbs = module.aux_cross = 0
    module.aux_fwd_ks_drop = module.aux_back_ks_drop = 0
    feats_sim = module.forward(xq, fhe="simulate")
    feats_exe = module.forward(xq, fhe="execute")
    np.testing.assert_array_equal(feats_exe, feats_sim)
