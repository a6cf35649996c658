"""Maxpool-stem lowering (RGB 7x7-stem topologies) tests."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dct_cryptonets.models import (build_spec, calibrate_scales, forward,
                                       init_model)
from dct_cryptonets.models.resnet import ModelSpec
from dct_cryptonets.models.topology import StemSpec
from dct_cryptonets.fhe.compiler import lower
from dct_cryptonets.fhe.circuit import Tlu, simulate
from dct_cryptonets.fhe.params import TEST_PARAMS
from dct_cryptonets.fhe.runtime import compile_qat_model

# small custom topology exercising the conv7/s2 + maxpool3/s2 stem shape
# (kept tiny: the execute test's wall time is ~linear in PBS sites on the
# 2-vCPU CI host)
POOLED = ModelSpec(
    name="pooledqat", block_counts=(1,), widths=(4,), in_channels=3,
    img_size=8, num_classes=4, bit_width=3, quantized=True,
    stem_override=StemSpec(3, 1, 1, 3, 2, 4, relu1=True),
)


def _prep(spec):
    params, state = init_model(jax.random.key(0), spec)
    x = jax.random.normal(jax.random.key(1), (4, spec.img_size,
                                              spec.img_size, spec.in_channels))
    _, _, state = forward(params, state, x, spec, train=True)
    params = calibrate_scales(params, state, x, spec)
    return params, state, x


def test_pooled_stem_simulator_matches_qat_exactly():
    """With rounding off, simulate == QAT forward through the maxpool."""
    params, state, x = _prep(POOLED)
    circ = lower(params, state, POOLED, rounding_threshold_bits=14,
                 residual_mode="requant")
    feats_sim = np.asarray(simulate(circ, x))
    feats_qat, _, _ = forward(params, state, x, POOLED, train=False)
    np.testing.assert_allclose(feats_sim, np.asarray(feats_qat), atol=1e-5)


@pytest.mark.slow
def test_pooled_stem_execute_matches_simulate():
    params, state, x = _prep(POOLED)
    # approximate rounding is bit-exact at TEST_PARAMS noise (same
    # contract test_fhe_e2e relies on; exact-rounding execute parity is
    # covered by test_exact_rounding) and skips the per-layer
    # clear_low_bits compiles that dominated this test's wall time;
    # pbs_batch=128 lets TLU layers share bootstrap executables.
    module = compile_qat_model(
        params, state, POOLED, n_bits=3,
        rounding_threshold_bits={"n_bits": 3, "method": "approximate"},
        tfhe_params=TEST_PARAMS, pbs_batch=128)
    module.keygen(seed=9)
    xin = np.asarray(x[:1])
    sim = module.forward(xin, fhe="simulate")
    exe = module.forward(xin, fhe="execute")
    np.testing.assert_array_equal(exe, sim)


def test_resnet18_rgb224_topology_lowers():
    """The reference RGB ImageNet topology (64_3_224) now lowers; shrink the
    spatial size for CPU test speed using the same stem shape."""
    spec = ModelSpec(
        name="rgbqat", block_counts=(2, 2), widths=(8, 16), in_channels=3,
        img_size=32, num_classes=10, bit_width=4, quantized=True,
        stem_override=StemSpec(7, 2, 3, 3, 2, 4, relu1=True),
    )
    params, state, x = _prep(spec)
    circ = lower(params, state, spec, calib_data=x)
    assert circ.max_bit_width() <= 16
    assert circ.verify_encodings() == []
    tlus = [op for op in circ.ops if isinstance(op, Tlu)]
    # stem relu + 8 pairwise-max relus + stem requant + blocks + head
    assert len(tlus) >= 1 + 8 + 1 + 6 + 1
    feats = simulate(circ, x)
    assert np.isfinite(np.asarray(feats)).all()
