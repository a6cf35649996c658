"""Circuit noise audit (fhe/noise_audit.py) and scale-unification tests."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dct_cryptonets.fhe.compiler import (lower, unify_multipliers,
                                             unify_multipliers_pc)
from dct_cryptonets.fhe.circuit import AddScaled, AddScaledPC, Tlu
from dct_cryptonets.fhe.noise_audit import MAX_DROP, audit_circuit
from dct_cryptonets.fhe.params import params_for_precision
from dct_cryptonets.models import (build_spec, calibrate_scales, forward,
                                       init_model)


import functools


@functools.lru_cache(maxsize=None)
def _flagship_cached(residual_mode):
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16,
                      num_classes=10, bit_width=4)
    params, state = init_model(jax.random.key(0), spec)
    x = jax.random.normal(jax.random.key(1), (8, 16, 16, 24))
    _, _, state = forward(params, state, x, spec, train=True)
    params = calibrate_scales(params, state, x, spec)
    return lower(params, state, spec, rounding_threshold_bits=6,
                 calib_data=x, residual_mode=residual_mode), x


def _flagship_circuit(residual_mode="fused"):
    # the lowering (incl. its calibration fixpoint) costs ~20 s cold on
    # this 2-vCPU host and many tests need the same circuit — cache it
    return _flagship_cached(residual_mode)


class TestUnifyMultipliers:
    def test_accuracy_bound(self):
        # hard 2^-7 guarantee for ratios within 8:1 (residual branches sit
        # well inside); larger ratios approach the cap-64 representability
        # limit but always beat the naive scheme
        rng = np.random.default_rng(0)
        errs = []
        for _ in range(300):
            sa = 10.0 ** rng.uniform(-1.5, 1.5)
            sb = sa * 2.0 ** rng.uniform(-3, 3)
            ca, cb, sv = unify_multipliers(sa, sb)
            assert 1 <= ca <= 64 and 1 <= cb <= 64
            assert abs(sv * ca - sa) / sa <= 2 ** -7 + 1e-12
            assert abs(sv * cb - sb) / sb <= 2 ** -7 + 1e-12
            errs.append(abs(sv * cb - sb) / sb)
        # errors cluster near (under) the bound by design: the search takes
        # the SMALLEST multiplier pair that meets it, trading unneeded
        # accuracy for lower noise amplification
        assert np.median(errs) <= 2 ** -7

    def test_extreme_ratios_never_worse_than_naive(self):
        for ratio in (20.0, 64.0, 300.0):
            ca, cb, sv = unify_multipliers(ratio, 1.0)
            err = abs(sv * cb - 1.0)     # error on the small branch
            # the naive scheme: ca=64, cb=round(64/ratio) clamped to >=1
            cb_naive = max(1, round(64 / ratio))
            err_naive = abs((ratio / 64) * cb_naive - 1.0)
            assert err <= err_naive + 1e-9
            ca2, cb2, _ = unify_multipliers(1.0, ratio)
            assert (ca2, cb2) == (cb, ca)  # symmetric

    def test_small_multipliers_for_simple_ratios(self):
        assert unify_multipliers(1.0, 1.0)[:2] == (1, 1)
        assert unify_multipliers(2.0, 1.0)[:2] == (2, 1)
        ca, cb, _ = unify_multipliers(0.578, 1.0)
        # continued fractions find 11/19 (err 0.1%), not 37/64
        assert ca * ca + cb * cb < 37 * 37 + 64 * 64

    def test_lowered_adds_use_small_multipliers(self):
        circ, _ = _flagship_circuit("requant")
        adds = [op for op in circ.ops if isinstance(op, AddScaled)
                and abs(op.ca) <= 64 and op.ca * op.cb > 1]
        assert adds, "flagship circuit should have residual adds"
        # minimal unification keeps the magnitude product well under the
        # naive ~64*rounded bound for at least most adds
        assert np.median([op.ca * op.cb for op in adds]) < 64 * 32

    def test_fused_adds_respect_range_cap(self):
        """Requant-elided adds: per-channel pairs keep every branch's
        contribution within the 2^13 range cap (the <=16-bit contract)
        with all encodings consistent."""
        circ, _ = _flagship_circuit("fused")
        pc_adds = [op for op in circ.ops if isinstance(op, AddScaledPC)]
        assert len(pc_adds) == 9            # one per block
        assert circ.max_bit_width() <= 16
        assert circ.verify_encodings() == []
        for op in pc_adds:
            assert np.abs(op.ca).max() <= 1 << 13
            assert np.abs(op.cb).max() <= 1 << 13

    def test_unify_pc_absolute_error_bound(self):
        """Per-channel unification honours the absolute-error adequacy:
        |s_v*q - rb| * bound_b <= out_step/4 whenever representable."""
        rng = np.random.default_rng(0)
        C = 64
        ka = rng.uniform(0.001, 0.02, C) * rng.choice([-1.0, 1.0], C)
        kb = np.full(C, 0.1)
        bnd_a = rng.integers(100, 900, C).astype(float)
        bnd_b = np.full(C, 7.0)
        step = 0.1
        ca, cb, s_v = unify_multipliers_pc(ka, kb, bnd_a, bnd_b, step)
        for c in range(C):
            if ca[c] == 0 or cb[c] == 0:
                continue
            # a-branch is exact by construction
            np.testing.assert_allclose(s_v[c] * abs(ca[c]), abs(ka[c]))
            err_abs = abs(s_v[c] * abs(cb[c]) - abs(kb[c])) * bnd_b[c]
            assert err_abs <= step / 4 + 1e-12
            assert abs(ca[c]) * bnd_a[c] <= 1 << 13
            assert abs(cb[c]) * bnd_b[c] <= 1 << 13

    def test_unify_pc_degenerate_channels(self):
        """Dead channels (k ~ 0) drop the branch; its bias still matters
        to the caller, so the multiplier is exactly 0, not tiny."""
        ka = np.asarray([1e-9, 0.5, 0.5])
        kb = np.asarray([0.5, 1e-9, -0.5])
        ca, cb, s_v = unify_multipliers_pc(ka, kb, [10.0, 10.0, 10.0],
                                           [10.0, 10.0, 10.0], 0.5)
        assert ca[0] == 0 and cb[0] != 0
        assert cb[1] == 0 and ca[1] != 0
        assert ca[2] > 0 and cb[2] < 0      # signs move into multipliers


class TestNoiseAudit:
    def test_flagship_meets_contract(self):
        circ, _ = _flagship_circuit()
        p = params_for_precision(6)
        res = audit_circuit(circ, p, p_error=0.015,
                            rounding_method="exact")
        assert res.max_p_error <= 0.015
        assert all(0 <= r.drop_limbs <= MAX_DROP for r in res.reports)
        # with the base-2^15 gadget the audit affords aggressive drops
        # (median 2 under the mask-perturbation-corrected drop model —
        # dropped BSK mask bytes convolve with the GLWE key at decryption,
        # a ~kN/2 variance factor validated by measurement,
        # tools/measure_drop_noise.py)
        assert res.aux_drop_limbs >= 2
        assert np.median([r.drop_limbs for r in res.reports]) >= 2
        # every TLU layer is reported exactly once
        tlus = [op for op in circ.ops if isinstance(op, Tlu)]
        assert len(res.reports) == len(tlus)
        assert res.summary().count("p_window") == len(tlus)

    def test_partial_clearing_saves_extractions(self):
        """The audit's keep_low skips extraction bootstraps where the
        honest junk accounting affords it, within p_error.

        Under the WORST-CASE bounded-junk pricing (r4: the uncleared bits
        shrink the window margin by their bound rather than adding a
        Gaussian-variance term — the old model grossly understated slips
        and was the source of r3's over-deep keep choices), the main
        mod-switch noise floor at r=6 (sigma_ms ~ 2^54.6 vs margin 2^56,
        p_floor ~ 7e-3) leaves room for keep_low only on the
        largest-shift layers."""
        circ, _ = _flagship_circuit()
        p = params_for_precision(6)
        res = audit_circuit(circ, p, p_error=0.01, rounding_method="exact")
        assert res.max_p_error <= 0.01
        full = sum(r.sites * r.shift for r in res.reports)
        cleared = sum(r.sites * r.cleared for r in res.reports)
        assert cleared <= full
        for r in res.reports:
            assert 0 <= r.keep_low <= min(r.shift, 6)
        # at the preset-6 mod-switch floor the 0.01 budget prices keep_low
        # out entirely (the cost-aware greedy prefers main drops); with a
        # looser contract the slack must buy uncleared bits again
        loose = audit_circuit(circ, p, p_error=0.05, rounding_method="exact")
        assert loose.max_p_error <= 0.05
        assert any(r.keep_low > 0 for r in loose.reports if r.shift >= 7)
        # a stricter contract can only keep fewer bits uncleared
        strict = audit_circuit(circ, p, p_error=0.001,
                               rounding_method="exact")
        strict_cleared = sum(r.sites * r.cleared for r in strict.reports)
        assert strict_cleared >= cleared

    def test_approximate_mode_has_no_extraction_term(self):
        circ, _ = _flagship_circuit()
        p = params_for_precision(6)
        res = audit_circuit(circ, p, p_error=0.015,
                            rounding_method="approximate")
        assert all(r.p_extract == 0.0 for r in res.reports)

    def test_tighter_contract_lowers_drops(self):
        circ, _ = _flagship_circuit()
        p = params_for_precision(6)
        loose = audit_circuit(circ, p, p_error=0.05,
                              rounding_method="exact")
        tight = audit_circuit(circ, p, p_error=0.012,
                              rounding_method="exact")
        total_loose = sum(r.drop_limbs for r in loose.reports)
        total_tight = sum(r.drop_limbs for r in tight.reports)
        assert total_tight <= total_loose
        assert tight.max_p_error <= 0.012 or total_tight == 0


def test_audit_policy_runtime_wiring():
    """compile(..., drop_policy='audit') picks audited drops at keygen."""
    from dct_cryptonets.fhe.runtime import compile_qat_model
    from dct_cryptonets.fhe.params import TEST_PARAMS
    from dct_cryptonets.models.resnet import ModelSpec
    from dct_cryptonets.models.topology import StemSpec

    spec = ModelSpec(name="tinyqat", block_counts=(1,), widths=(4,),
                     in_channels=3, img_size=8, num_classes=4, bit_width=3,
                     quantized=True,
                     stem_override=StemSpec(3, 1, 1, None, None, 8,
                                            relu1=True))
    params, state = init_model(jax.random.key(0), spec)
    x = jax.random.normal(jax.random.key(1), (4, 8, 8, 3))
    _, _, state = forward(params, state, x, spec, train=True)
    params = calibrate_scales(params, state, x, spec)
    m = compile_qat_model(params, state, spec, n_bits=3,
                          rounding_threshold_bits=3,
                          tfhe_params=TEST_PARAMS, drop_policy="audit")
    res = m.run_audit()
    assert res is m.run_audit()          # cached
    assert set(res.by_acc) == {op.x for op in m.circuit.ops
                               if isinstance(op, Tlu)}
