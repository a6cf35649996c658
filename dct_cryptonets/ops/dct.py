"""Blockwise 2-D DCT-II / IDCT on the accelerator.

Computes the orthonormal type-II DCT per non-overlapping S x S tile of a
batch of images, returning the JPEG-style coefficient layout
``(B, H/S, W/S, S*S)``.

Reference behavior being matched (not ported):
  * ``matrix2dct`` (reference data/cvfunctional.py:37-57) - per-block
    ``T @ X @ T.T`` with the orthonormal basis, after a -128 level shift.
  * For ``filter_size == 8`` the reference goes through libjpeg at
    quality 100 (cvfunctional.py:21-26); at quality 100 the quantization
    table is all-ones, so the emitted coefficients equal the orthonormal
    2-D DCT of the level-shifted block rounded to the nearest integer
    (the JPEG normalization ``C(u)C(v)/4 . sum cos cos`` coincides with the
    orthonormal scaling for N=8).

Instead of a Python loop over blocks, the whole batch is reshaped into
``(num_blocks, S, S)`` tiles and hit with two einsums -> a pair of batched
matmuls that XLA fuses.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def dct_basis(size: int) -> np.ndarray:
    """Orthonormal DCT-II basis matrix T (size x size), float32.

    T[0, j] = 1/sqrt(N);  T[i, j] = sqrt(2/N) * cos((2j+1) i pi / 2N).
    Matches the basis built in reference cvfunctional.py:41-47.
    """
    i = np.arange(size)[:, None].astype(np.float64)
    j = np.arange(size)[None, :].astype(np.float64)
    T = np.sqrt(2.0 / size) * np.cos((2 * j + 1) * i * np.pi / (2 * size))
    T[0, :] = 1.0 / np.sqrt(size)
    return T.astype(np.float32)


def _to_blocks(x: jax.Array, size: int) -> jax.Array:
    """(..., H, W) -> (..., H/S, W/S, S, S) non-overlapping tiles."""
    *lead, H, W = x.shape
    nh, nw = H // size, W // size
    x = x.reshape(*lead, nh, size, nw, size)
    # (..., nh, S, nw, S) -> (..., nh, nw, S, S)
    return jnp.moveaxis(x, -3, -2)

def _from_blocks(x: jax.Array) -> jax.Array:
    """(..., nh, nw, S, S) -> (..., nh*S, nw*S)."""
    *lead, nh, nw, s, _ = x.shape
    x = jnp.moveaxis(x, -2, -3)  # (..., nh, S, nw, S)
    return x.reshape(*lead, nh * s, nw * s)


def blockwise_dct2(x: jax.Array, size: int, level_shift: bool = True,
                   round_coeffs: bool = False) -> jax.Array:
    """Blockwise orthonormal 2-D DCT-II.

    Args:
      x: (..., H, W) pixel plane (float or uint8); H, W divisible by `size`.
      size: tile size S (4 or 8 in the reference configs; any S works).
      level_shift: subtract 128 before the transform (JPEG convention,
        reference cvfunctional.py:39).
      round_coeffs: round coefficients to nearest integer — emulates the
        libjpeg quality-100 integer coefficients of the fs==8 path.

    Returns:
      (..., H/S, W/S, S*S) float32 coefficients, channel-last zig-zag-free
      row-major layout (matches ``tmp_dct.reshape(-1)``, cvfunctional.py:56).
    """
    x = x.astype(jnp.float32)
    if level_shift:
        x = x - 128.0
    T = jnp.asarray(dct_basis(size))
    blocks = _to_blocks(x, size)                     # (..., nh, nw, S, S)
    # T @ X @ T^T as two matmuls over the trailing dims.
    # HIGHEST keeps full f32 (the default may round operands to TF32 or
    # bf16, which breaks integer-coefficient parity with libjpeg).
    coeffs = jnp.einsum("ij,...jk,lk->...il", T, blocks, T,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
    if round_coeffs:
        coeffs = jnp.round(coeffs)
    *lead, nh, nw, s, _ = coeffs.shape
    return coeffs.reshape(*lead, nh, nw, s * s)


def blockwise_idct2(coeffs: jax.Array, size: int, level_shift: bool = True) -> jax.Array:
    """Inverse of :func:`blockwise_dct2` (orthonormal, so the transpose)."""
    *lead, nh, nw, ss = coeffs.shape
    assert ss == size * size
    T = jnp.asarray(dct_basis(size))
    blocks = coeffs.reshape(*lead, nh, nw, size, size)
    x = jnp.einsum("ji,...jk,kl->...il", T, blocks, T,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    out = _from_blocks(x)
    if level_shift:
        out = out + 128.0
    return out
