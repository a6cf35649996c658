"""Post-training quantization path (reference compile_torch_model branch,
homomorphic_eval.py:95-98, 287-295): float model -> calibrated integer
circuit -> encrypted execution."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dct_cryptonets.models import (build_spec, forward, init_model,
                                       quantize_float_model)
from dct_cryptonets.models.resnet import ModelSpec
from dct_cryptonets.models.topology import StemSpec
from dct_cryptonets.fhe.circuit import Tlu, simulate
from dct_cryptonets.fhe.params import TEST_PARAMS
from dct_cryptonets.fhe.runtime import compile_ptq_model

TINY_F = ModelSpec(
    name="tiny", block_counts=(1,), widths=(4,), in_channels=3,
    img_size=4, num_classes=4, bit_width=4, quantized=False,
    stem_override=StemSpec(1, 1, 0, None, None, 4, relu1=True),
)


def _trained_float(spec, seed=0, steps=3):
    params, state = init_model(jax.random.key(seed), spec)
    x = jax.random.normal(jax.random.key(seed + 1), (16, spec.img_size,
                                                     spec.img_size,
                                                     spec.in_channels))
    for _ in range(steps):
        _, _, state = forward(params, state, x, spec, train=True)
    return params, state, x


def test_quantize_float_model_grafts_and_calibrates():
    params, state, x = _trained_float(TINY_F)
    params_q, spec_q = quantize_float_model(params, state, x, TINY_F,
                                            n_bits=6)
    assert spec_q.quantized and spec_q.bit_width == 6
    # trained leaves carried over exactly
    np.testing.assert_array_equal(np.asarray(params_q["stem"]["conv"]["w"]),
                                  np.asarray(params["stem"]["conv"]["w"]))
    # quantizer scales exist and are calibrated (not the 1.0 init)
    assert float(params_q["stem"]["quant_in"]["scale"]) != 1.0
    assert float(params_q["blocks"][0]["relu1"]["scale"]) > 0


def test_ptq_simulate_tracks_float_forward():
    """At 6-bit PTQ without rounding the integer circuit should closely
    track the float model on the calibration distribution."""
    params, state, x = _trained_float(TINY_F)
    module = compile_ptq_model(params, state, TINY_F, np.asarray(x),
                               n_bits=6, rounding_threshold_bits=16,
                               tfhe_params=TEST_PARAMS)
    assert module.circuit.verify_encodings() == []
    feats_sim = module.forward(np.asarray(x), fhe="simulate")
    feats_float, _, _ = forward(params, state, x, TINY_F, train=False)
    a = feats_sim.ravel()
    b = np.asarray(feats_float).ravel()
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.98, corr
    # scale agreement too, not just correlation
    err = np.abs(a - b).mean() / (np.abs(b).mean() + 1e-9)
    assert err < 0.25, err


@pytest.mark.slow
def test_ptq_execute_matches_simulate():
    params, state, x = _trained_float(TINY_F)
    module = compile_ptq_model(params, state, TINY_F, np.asarray(x[:8]),
                               n_bits=3, rounding_threshold_bits=3,
                               tfhe_params=TEST_PARAMS, pbs_batch=512)
    module.keygen(seed=8)
    xin = np.asarray(x[:1])
    sim = module.forward(xin, fhe="simulate")
    exe = module.forward(xin, fhe="execute")
    np.testing.assert_array_equal(exe, sim)


def test_ptq_rejects_qat_spec():
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16)
    params, state = init_model(jax.random.key(0), spec)
    x = jnp.zeros((2, 16, 16, 24))
    try:
        quantize_float_model(params, state, x, spec)
    except AssertionError:
        return
    raise AssertionError("expected rejection of an already-QAT spec")
