"""Unit tests for the blockwise DCT kernels and the codec pipeline.

Ground truth: scipy.fft.dctn (orthonormal) per tile, plus a hand-rolled numpy
reimplementation of the reference's per-block T @ X @ T^T loop
(reference cvfunctional.py:37-57) to pin numerics.
"""
import numpy as np
import pytest
import scipy.fft

import jax
import jax.numpy as jnp

from dct_cryptonets.ops.dct import blockwise_dct2, blockwise_idct2, dct_basis
from dct_cryptonets.data.codec import (
    CodecConfig, dct_ingest, dct_ingest_train, dct_from_pixels,
    rgb_to_ycrcb_cv,
)
from dct_cryptonets.data.tables import subset_indices, normalization_stats


def ref_matrix2dct(matrix, size):
    """Numpy reimplementation of the reference blockwise DCT semantics."""
    m = matrix.astype(np.int16) - 128
    T = dct_basis(size).astype(np.float64)
    nh, nw = m.shape[0] // size, m.shape[1] // size
    out = np.zeros((nh, nw, size * size))
    for i in range(nh):
        for j in range(nw):
            blk = m[i * size:(i + 1) * size, j * size:(j + 1) * size]
            out[i, j] = (T @ blk @ T.T).reshape(-1)
    return out


@pytest.mark.parametrize("size", [4, 8])
def test_blockwise_dct_matches_scipy(size):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, size * 4, size * 4)).astype(np.float32)
    got = np.asarray(blockwise_dct2(jnp.asarray(x), size))
    for b in range(2):
        for i in range(4):
            for j in range(4):
                blk = x[b, i * size:(i + 1) * size, j * size:(j + 1) * size] - 128
                want = scipy.fft.dctn(blk, norm="ortho")
                np.testing.assert_allclose(
                    got[b, i, j].reshape(size, size), want, atol=1e-3)


@pytest.mark.parametrize("size", [4, 8])
def test_blockwise_dct_matches_reference_loop(size):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (size * 5, size * 3)).astype(np.uint8)
    got = np.asarray(blockwise_dct2(jnp.asarray(x), size))
    want = ref_matrix2dct(x, size)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_dct_roundtrip():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (3, 32, 32)).astype(np.float32)
    c = blockwise_dct2(jnp.asarray(x), 4)
    back = blockwise_idct2(c, 4)
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-3)


def test_ycrcb_matches_cv_formula():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (1, 4, 4, 3)).astype(np.uint8)
    out = np.asarray(rgb_to_ycrcb_cv(jnp.asarray(x)))
    xf = x.astype(np.float64)
    y = 0.299 * xf[..., 0] + 0.587 * xf[..., 1] + 0.114 * xf[..., 2]
    cr = np.clip(np.round((xf[..., 0] - y) * 0.713 + 128), 0, 255)
    cb = np.clip(np.round((xf[..., 2] - y) * 0.564 + 128), 0, 255)
    np.testing.assert_allclose(out[..., 1], cr, atol=1)
    np.testing.assert_allclose(out[..., 2], cb, atol=1)


def test_subset_tables_shapes():
    y, cb, cr = subset_indices(24, "default", 4)
    assert len(y) + len(cb) + len(cr) == 24
    assert max(y) < 16 and max(cb) < 16  # fs-4 tables index 4x4=16 coeffs
    y8, cb8, cr8 = subset_indices(64, "default", 8)
    assert len(y8) + len(cb8) + len(cr8) == 64
    assert max(y8) < 64
    mean, std = normalization_stats(24)
    assert mean.shape == (24,) and std.shape == (24,)
    assert np.all(std > 0)


def test_ingest_shapes_cifar_config():
    """Primary config: CIFAR-10 DCT 24x16^2, filter_size 4."""
    cfg = CodecConfig(channels=24, filter_size=4, image_size_dct=16)
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    out = dct_ingest(jnp.asarray(imgs), cfg)
    assert out.shape == (2, 16, 16, 24)
    assert np.isfinite(np.asarray(out)).all()
    # train path
    out_t = dct_ingest_train(jax.random.key(0), jnp.asarray(imgs), cfg)
    assert out_t.shape == (2, 16, 16, 24)
    assert np.isfinite(np.asarray(out_t)).all()


def test_ingest_shapes_imagenet_config():
    """ImageNet config: DCT 64x56^2, filter_size 8."""
    cfg = CodecConfig(channels=64, filter_size=8, image_size_dct=56)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (1, 500, 400, 3)).astype(np.uint8)
    out = dct_ingest(jnp.asarray(imgs), cfg)
    assert out.shape == (1, 56, 56, 64)
    assert np.isfinite(np.asarray(out)).all()


def test_dct_from_pixels_normalization_applied():
    cfg = CodecConfig(channels=24, filter_size=4, image_size_dct=16)
    imgs = np.full((1, 64, 64, 3), 128, dtype=np.uint8)
    out = np.asarray(dct_from_pixels(jnp.asarray(imgs), cfg))
    mean, std = cfg.stats()
    # A flat gray image has DC-only coefficients; every AC channel must be
    # exactly (0 - mean)/std.
    y_idx, cb_idx, cr_idx = cfg.subset()
    k = len(y_idx)
    for ch in range(1, k):  # skip the DC channel 0
        if y_idx[ch] != 0:
            np.testing.assert_allclose(
                out[..., ch], (0 - mean[ch]) / std[ch], atol=1e-3)
