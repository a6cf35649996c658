"""Compiler coverage across the reference model configurations."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dct_cryptonets.models import (build_spec, calibrate_scales, forward,
                                       init_model)
from dct_cryptonets.fhe.compiler import lower
from dct_cryptonets.fhe.circuit import Conv, Tlu, simulate
from dct_cryptonets.fhe.params import params_for_precision


def _prep(spec, B=4):
    params, state = init_model(jax.random.key(0), spec)
    x = jax.random.normal(jax.random.key(1), (B, spec.img_size,
                                              spec.img_size, spec.in_channels))
    _, _, state = forward(params, state, x, spec, train=True)
    params = calibrate_scales(params, state, x, spec)
    return params, state, x


def test_resnet20_cifar_dct_lowering():
    """Flagship: CIFAR-10 ResNet-20 DCT 24x16^2, r=6 (reference headline)."""
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16,
                      num_classes=10, bit_width=4)
    params, state, x = _prep(spec)
    circ = lower(params, state, spec, rounding_threshold_bits=6,
                 residual_mode="requant")
    assert circ.max_bit_width() <= 16          # homomorphic_eval.py:301-306
    # every TLU/add must be materialized against actual torus encodings
    # (regression: shared-tensor budget inflation broke shortcut TLUs)
    assert circ.verify_encodings() == []
    circ_cal = lower(params, state, spec, rounding_threshold_bits=6,
                     calib_data=x, residual_mode="requant")
    assert circ_cal.verify_encodings() == []
    # stem TLU + 9 blocks (3 TLUs each + 1 extra on the two transition
    # blocks' conv shortcuts) + head pool TLU
    tlus = [op for op in circ.ops if isinstance(op, Tlu)]
    assert len(tlus) == 1 + 9 * 3 + 2 + 1
    feats = simulate(circ, x)
    assert feats.shape == (4, 64)
    # TLU precision must fit the r=6 parameter preset
    max_r = max(op.spec.in_bits for op in tlus)
    assert params_for_precision(max_r).message_bits >= max_r

    # fused (default) mode: quant_out/quant_sc TLU layers elided — only
    # the true nonlinearities remain (stem, 2 relus per block, pool)
    circ_f = lower(params, state, spec, rounding_threshold_bits=6,
                   calib_data=x)
    tlus_f = [op for op in circ_f.ops if isinstance(op, Tlu)]
    assert len(tlus_f) == 1 + 9 * 2 + 1
    assert circ_f.verify_encodings() == []
    assert circ_f.max_bit_width() <= 16
    assert circ_f.num_pbs == 196_672           # vs 307,264 requant
    feats_f = simulate(circ_f, x)
    assert feats_f.shape == (4, 64)


@pytest.mark.slow
def test_resnet18_fs8_end_to_end_simulate():
    """ResNet-18 through the REAL fs=8 JPEG codec, end-to-end: fixture
    images -> bit-exact libjpeg-path ingest ('64_24_56' DCT config) ->
    QAT lowering -> integer simulate.

    (The reference README's CIFAR ResNet-18 DCT row "(24, 16, 16)"
    (README.md:88) is not buildable from the shipped reference code — no
    '64_24_16' topology entry, and 16^2 input shrinks below the avgpool
    kernel — so the runnable 24-channel 56^2 ResNet-18 config stands in;
    see models/topology.py.)"""
    import os
    from dct_cryptonets.data.codec import CodecConfig, dct_ingest
    z = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "codec_fs8.npz"))
    cfg = CodecConfig(channels=24, filter_size=8, image_size_dct=56)
    x = dct_ingest(jnp.asarray(z["images"][:2]), cfg)
    assert x.shape == (2, 56, 56, 24)
    spec = build_spec("ResNet18qat", in_channels=24, img_size=56,
                      num_classes=10, bit_width=4)
    params, state = init_model(jax.random.key(0), spec)
    _, _, state = forward(params, state, x, spec, train=True)
    params = calibrate_scales(params, state, x, spec)
    circ = lower(params, state, spec, rounding_threshold_bits=6,
                 calib_data=np.asarray(x))
    assert circ.max_bit_width() <= 16          # homomorphic_eval.py:301-306
    assert circ.verify_encodings() == []
    feats = simulate(circ, x)
    assert feats.shape == (2, 512)
    assert np.isfinite(np.asarray(feats)).all()


@pytest.mark.slow
def test_resnet18_imagenet_dct_lowering():
    """ImageNet config: ResNet-18 DCT 64x56^2, r=7 (reference README.md:92).

    Needs calibration-based accumulator budgets — worst-case bounds for
    3x3x512 int5 convs exceed 16 bits (Concrete hits the same and also
    calibrates)."""
    spec = build_spec("ResNet18qat", in_channels=64, img_size=56,
                      num_classes=1000, bit_width=5)
    params, state, x = _prep(spec, B=2)
    circ = lower(params, state, spec, rounding_threshold_bits=7,
                 calib_data=x, residual_mode="requant")
    assert circ.max_bit_width() <= 16
    assert circ.verify_encodings() == []
    tlus = [op for op in circ.ops if isinstance(op, Tlu)]
    # stem (no relu1 for 64_64_56) + 8 blocks (3 TLUs + shortcut TLU on the
    # three transition blocks) + head
    assert len(tlus) == 1 + 8 * 3 + 3 + 1
    assert max(op.spec.in_bits for op in tlus) <= 7
    feats = simulate(circ, x)
    assert feats.shape == (2, 512)
    assert circ.num_pbs > 500_000  # deeper net, many more bootstraps

    # fused mode shrinks the circuit to the nonlinearities
    circ_f = lower(params, state, spec, rounding_threshold_bits=7,
                   calib_data=x)
    tlus_f = [op for op in circ_f.ops if isinstance(op, Tlu)]
    assert len(tlus_f) == 1 + 8 * 2 + 1
    assert circ_f.max_bit_width() <= 16
    assert circ_f.verify_encodings() == []
    assert circ_f.num_pbs < circ.num_pbs


def test_weights_are_narrow_range_int():
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16)
    params, state, _ = _prep(spec)
    circ = lower(params, state, spec)
    for op in circ.ops:
        if isinstance(op, Conv):
            qmax = 2 ** (spec.bit_width - 1) - 1
            assert op.w.dtype == np.int32
            assert op.w.min() >= -qmax and op.w.max() <= qmax
