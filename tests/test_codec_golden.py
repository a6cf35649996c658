"""Golden codec parity vs the REFERENCE'S OWN code.

``tests/golden/codec_fs4.npz`` was generated by running the reference eval
transform (Resize -> CenterCrop -> GetDCT -> UpScaleDCT -> ToTensorDCT ->
SubsetDCT -> Aggregate -> NormalizeDCT, reference data/datamgr.py:193-220)
and the raw codec kernels (``transform_dct_size``, reference
data/cvfunctional.py:59-74) on deterministic fixture images — see
tools/make_codec_golden.py.  These tests pin our fused on-device codec to
those numbers element-wise, so any numeric drift (color-conversion
fixed-point, cv2 resize semantics, DCT basis, channel subsets,
normalization stats) fails here instead of silently costing accuracy
parity (the reference's 90.5% CIFAR-10 target trains on exactly this
pipeline's outputs).

The matched cv2 semantics, for the record:
  * BGR2YCrCb is 14-bit fixed point, NOT the float formula rounded;
  * INTER_LINEAR on 8U is 2^11 fixed point with cvRound'd (half-to-even)
    weights and the quirky vertical combine
    ``(((b0*(r0>>4))>>16) + ((b1*(r1>>4))>>16) + 2) >> 2``;
  * exact-2x downscale reroutes to the area-fast path, whose arithmetic
    the same vertical combine reproduces;
  * center-crop offsets use Python round-half-to-even.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from dct_cryptonets.data.codec import (CodecConfig, dct_from_pixels,
                                           dct_ingest, resize_linear_u8_cv,
                                           rgb_to_ycrcb_cv)
from dct_cryptonets.ops.dct import blockwise_dct2

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "codec_fs4.npz")
GOLDEN8 = os.path.join(os.path.dirname(__file__), "golden", "codec_fs8.npz")


@pytest.fixture(scope="module")
def golden():
    assert os.path.exists(GOLDEN), (
        "golden file missing — regenerate with tools/make_codec_golden.py")
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def golden8():
    assert os.path.exists(GOLDEN8), (
        "fs=8 golden missing — regenerate with tools/make_codec_golden.py "
        "--filter_size 8")
    return np.load(GOLDEN8)


def test_raw_dct_kernels_match_reference(golden):
    """transform_dct_size parity on pre-cropped pixels: color conversion,
    chroma halving, and the blockwise DCT (fs=4 manual path)."""
    fs = int(golden["filter_size"])
    crop = jnp.asarray(golden["cropped"])
    ycc = rgb_to_ycrcb_cv(crop)
    cy = blockwise_dct2(ycc[..., 0], fs, level_shift=True, round_coeffs=False)
    np.testing.assert_allclose(np.asarray(cy), golden["dct_y"], atol=1e-4)
    hh, hw = crop.shape[1] // 2, crop.shape[2] // 2
    cb = resize_linear_u8_cv(ycc[..., 1], hh, hw)
    cr = resize_linear_u8_cv(ycc[..., 2], hh, hw)
    ccb = blockwise_dct2(cb, fs, level_shift=True, round_coeffs=False)
    ccr = blockwise_dct2(cr, fs, level_shift=True, round_coeffs=False)
    np.testing.assert_allclose(np.asarray(ccb), golden["dct_cb"], atol=1e-4)
    np.testing.assert_allclose(np.asarray(ccr), golden["dct_cr"], atol=1e-4)


def test_full_eval_pipeline_matches_reference(golden):
    """dct_ingest == the reference's composed eval transform, element-wise
    (uint8 stages bit-exact; float DCT/normalize within 1e-3)."""
    cfg = CodecConfig(channels=int(golden["channels"]),
                      filter_size=int(golden["filter_size"]),
                      image_size_dct=int(golden["image_size_dct"]))
    ours = np.asarray(dct_ingest(jnp.asarray(golden["images"]), cfg))
    ref = np.transpose(golden["full_pipeline"], (0, 2, 3, 1))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-3)


def test_fs8_raw_coefficients_bit_exact(golden8):
    """fs=8 (JPEG) path: the integer islow/jccolor/h2v2 pipeline
    (ops/jpegdct.py) must be BIT-exact vs the real libjpeg encoder's
    coefficients (golden generated via PIL's libjpeg + the baseline
    bitstream parser in tools/jpeg_oracle.py — the reference's
    TurboJPEG-quality-100 + jpeg2dct path, cvfunctional.py:21-26,
    including its TJPF_BGR-on-RGB channel-swap quirk)."""
    from dct_cryptonets.ops.jpegdct import jpeg_q100_coefficients
    cy, ccb, ccr = jpeg_q100_coefficients(jnp.asarray(golden8["cropped"]))
    np.testing.assert_array_equal(np.asarray(cy), golden8["dct_y"])
    np.testing.assert_array_equal(np.asarray(ccb), golden8["dct_cb"])
    np.testing.assert_array_equal(np.asarray(ccr), golden8["dct_cr"])


def test_fs8_full_eval_pipeline_matches_reference(golden8):
    """fs=8 dct_ingest == the reference's composed eval transform (the
    ResNet-18 CIFAR DCT ingest, README.md:88) — integer stages bit-exact,
    float normalize within 1e-3."""
    cfg = CodecConfig(channels=int(golden8["channels"]),
                      filter_size=int(golden8["filter_size"]),
                      image_size_dct=int(golden8["image_size_dct"]))
    ours = np.asarray(dct_ingest(jnp.asarray(golden8["images"]), cfg))
    ref = np.transpose(golden8["full_pipeline"], (0, 2, 3, 1))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-3)


def test_dct_from_pixels_matches_on_cropped(golden):
    """The fused pipeline from GetDCT onward (no resize/crop) also matches
    when fed exactly pre-cropped pixels."""
    cfg = CodecConfig(channels=int(golden["channels"]),
                      filter_size=int(golden["filter_size"]),
                      image_size_dct=int(golden["image_size_dct"]))
    # reference full pipeline on the SAME pixels: emulate by cropping the
    # golden fixture path — reproduce Resize+CenterCrop exactly, then both
    # halves must agree end-to-end (this isolates dct_from_pixels).
    imgs = jnp.asarray(golden["images"])
    P = cfg.pixel_size
    rs = int(P * 1.15)
    planes = jnp.moveaxis(imgs, -1, -3)
    planes = resize_linear_u8_cv(planes, rs, rs)
    resized = jnp.moveaxis(planes, -3, -1)
    top = int(np.round((rs - P) * 0.5))
    cropped = resized[:, top:top + P, top:top + P, :]
    a = np.asarray(dct_from_pixels(cropped, cfg))
    b = np.asarray(dct_ingest(imgs, cfg))
    np.testing.assert_allclose(a, b, atol=1e-5)
