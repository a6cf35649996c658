"""Batched on-device spatial/color transforms (the cvtransforms equivalents).

The reference ships an OpenCV-backed clone of the torchvision transform
library for numpy images (reference cvtransforms.py:281-1597 with kernels in
cvfunctional.py:90-893): Resize, CenterCrop, RandomCrop, RandomResizedCrop,
flips, ColorJitter/ImageJitter, rotation, affine, perspective, additive
noise, Rescale.  Its composed pipelines run per-sample in DataLoader worker
processes on the host CPU.

This module re-owns that layer on the accelerator: every transform is a pure function
over a *batch* ``(B, H, W, C)`` float tensor (plus a PRNG key where random),
jit/vmap-friendly with static output shapes, so whole augmentation pipelines
fuse into the ingest step on device (see codec.dct_ingest_train).

Geometric transforms (rotate / affine / perspective) share one inverse-warp
bilinear sampler: the output grid is pulled back through the inverse
coordinate map and sampled bilinearly — the same semantics as
``cv2.warpAffine``/``cv2.warpPerspective`` with ``INTER_LINEAR`` and constant
border fill (reference cvfunctional.py:744-865).  The warp is expressed as
gather-free take-along-axis lookups on static shapes so XLA lowers it to
dense dynamic-slices/one-hot matmuls that vectorize.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .codec import center_crop, resize_bilinear  # re-exported pipeline stages

__all__ = [
    "resize", "rescale", "center_crop", "random_crop", "pad",
    "hflip", "vflip", "random_hflip", "random_vflip",
    "color_jitter", "grayscale",
    "rotate", "affine", "perspective",
    "random_rotation", "random_affine", "random_perspective",
    "gaussian_noise", "salt_pepper_noise",
    "compose",
]


# ---------------------------------------------------------------------------
# sizing


def resize(x: jax.Array, size: int | tuple[int, int]) -> jax.Array:
    """Resize to ``size`` (int -> shorter-side semantics are NOT applied;
    the reference pipelines always pass explicit square sizes,
    datamgr.py:193-205)."""
    if isinstance(size, int):
        size = (size, size)
    return resize_bilinear(x, size[0], size[1])


def rescale(x: jax.Array, factor: float) -> jax.Array:
    """Scale H and W by ``factor`` (reference cvtransforms Rescale)."""
    h = int(round(x.shape[-3] * factor))
    w = int(round(x.shape[-2] * factor))
    return resize_bilinear(x, h, w)


def pad(x: jax.Array, padding: int, fill: float = 0.0) -> jax.Array:
    p = padding
    return jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)),
                   constant_values=fill)


def random_crop(key: jax.Array, x: jax.Array, size: int,
                padding: int = 0) -> jax.Array:
    """Batched RandomCrop (reference cvtransforms RandomCrop): optional
    zero padding then a uniform-position size x size crop per sample."""
    if padding:
        x = pad(x, padding)
    B, H, W, C = x.shape
    ky, kx = jax.random.split(key)
    top = jax.random.randint(ky, (B,), 0, H - size + 1)
    left = jax.random.randint(kx, (B,), 0, W - size + 1)

    def one(img, t, l):
        return jax.lax.dynamic_slice(img, (t, l, 0), (size, size, C))

    return jax.vmap(one)(x, top, left)


# ---------------------------------------------------------------------------
# flips


def hflip(x: jax.Array) -> jax.Array:
    return x[..., :, ::-1, :]


def vflip(x: jax.Array) -> jax.Array:
    return x[..., ::-1, :, :]


def random_hflip(key: jax.Array, x: jax.Array, p: float = 0.5) -> jax.Array:
    flip = jax.random.bernoulli(key, p, (x.shape[0], 1, 1, 1))
    return jnp.where(flip, hflip(x), x)


def random_vflip(key: jax.Array, x: jax.Array, p: float = 0.5) -> jax.Array:
    flip = jax.random.bernoulli(key, p, (x.shape[0], 1, 1, 1))
    return jnp.where(flip, vflip(x), x)


# ---------------------------------------------------------------------------
# photometric


def grayscale(x: jax.Array, keep_channels: bool = True) -> jax.Array:
    """ITU-R 601 luma (reference cvfunctional to_grayscale)."""
    g = (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]
    return jnp.repeat(g, 3, axis=-1) if keep_channels else g


def color_jitter(key: jax.Array, x: jax.Array, brightness: float = 0.0,
                 contrast: float = 0.0, saturation: float = 0.0,
                 hue: float = 0.0, lo: float = 0.0,
                 hi: float = 255.0) -> jax.Array:
    """Batched ColorJitter (reference cvtransforms ColorJitter semantics:
    factors U(max(0, 1-a), 1+a); hue as a U(-h, h) turn of the hue wheel).

    Hue rotation uses the YIQ-approximation rotation matrix, matching the
    effect (not the bit pattern) of the reference's HSV round trip.
    """
    B = x.shape[0]
    kb, kc, ks, kh = jax.random.split(key, 4)

    if brightness:
        f = jax.random.uniform(kb, (B, 1, 1, 1),
                               minval=max(0.0, 1 - brightness),
                               maxval=1 + brightness)
        x = x * f
    if contrast:
        f = jax.random.uniform(kc, (B, 1, 1, 1),
                               minval=max(0.0, 1 - contrast),
                               maxval=1 + contrast)
        mean = grayscale(x, keep_channels=False).mean(
            axis=(1, 2), keepdims=True)
        x = mean + (x - mean) * f
    if saturation:
        f = jax.random.uniform(ks, (B, 1, 1, 1),
                               minval=max(0.0, 1 - saturation),
                               maxval=1 + saturation)
        g = grayscale(x, keep_channels=False)
        x = g + (x - g) * f
    if hue:
        theta = (jax.random.uniform(kh, (B, 1, 1),
                                    minval=-hue, maxval=hue) * 2 * jnp.pi)
        cos, sin = jnp.cos(theta), jnp.sin(theta)
        # rotate chroma around the gray axis (unit luma direction)
        yiq = jnp.einsum("bhwc,cd->bhwd", x, jnp.asarray(
            [[0.299, 0.596, 0.211],
             [0.587, -0.274, -0.523],
             [0.114, -0.322, 0.312]], jnp.float32))
        i, q = yiq[..., 1], yiq[..., 2]
        ir = cos * i - sin * q
        qr = sin * i + cos * q
        yiq = jnp.stack([yiq[..., 0], ir, qr], axis=-1)
        x = jnp.einsum("bhwd,dc->bhwc", yiq, jnp.asarray(
            [[1.0, 1.0, 1.0],
             [0.956, -0.272, -1.106],
             [0.621, -0.647, 1.703]], jnp.float32))
    return jnp.clip(x, lo, hi)


def gaussian_noise(key: jax.Array, x: jax.Array, mean: float = 0.0,
                   std: float = 10.0, lo: float = 0.0,
                   hi: float = 255.0) -> jax.Array:
    """Additive gaussian noise (reference cvfunctional gaussian_noise,
    cvfunctional.py:866-879)."""
    return jnp.clip(x + mean + std * jax.random.normal(key, x.shape), lo, hi)


def salt_pepper_noise(key: jax.Array, x: jax.Array, prob: float = 0.01,
                      lo: float = 0.0, hi: float = 255.0) -> jax.Array:
    """Salt-and-pepper noise (reference cvfunctional poisson/salt noise
    family, cvfunctional.py:880-893): each pixel independently becomes
    ``hi`` with probability prob/2 or ``lo`` with probability prob/2."""
    ku, kv = jax.random.split(key)
    u = jax.random.uniform(ku, x.shape[:3] + (1,))
    salt = u < prob / 2
    pepper = u > 1 - prob / 2
    x = jnp.where(salt, hi, x)
    return jnp.where(pepper, lo, x)


# ---------------------------------------------------------------------------
# geometric warps — one shared inverse-map bilinear sampler


def _warp_bilinear(x: jax.Array, inv: jax.Array,
                   fill: float = 0.0) -> jax.Array:
    """Sample ``x`` (B, H, W, C) through per-sample inverse maps.

    inv: (B, 3, 3) projective matrices taking OUTPUT pixel homogeneous
    coords (col, row, 1) to INPUT coords — the cv2.warpPerspective
    ``WARP_INVERSE_MAP`` convention.  Out-of-bounds samples get ``fill``.
    """
    B, H, W, C = x.shape
    cols, rows = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32),
                              jnp.arange(H, dtype=jnp.float32))
    ones = jnp.ones_like(cols)
    grid = jnp.stack([cols, rows, ones], axis=-1)          # (H, W, 3)
    src = jnp.einsum("bij,hwj->bhwi", inv, grid)           # (B, H, W, 3)
    sx = src[..., 0] / jnp.maximum(jnp.abs(src[..., 2]), 1e-8) * jnp.sign(src[..., 2])
    sy = src[..., 1] / jnp.maximum(jnp.abs(src[..., 2]), 1e-8) * jnp.sign(src[..., 2])

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = sx - x0
    fy = sy - y0

    def tap(yi, xi):
        """Clamped lookup + in-bounds mask."""
        inb = ((xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1))
        xc = jnp.clip(xi, 0, W - 1).astype(jnp.int32)
        yc = jnp.clip(yi, 0, H - 1).astype(jnp.int32)
        flat = x.reshape(B, H * W, C)
        idx = (yc * W + xc).reshape(B, H * W)
        v = jnp.take_along_axis(flat, idx[..., None], axis=1)
        v = v.reshape(B, H, W, C)
        return jnp.where(inb[..., None], v, fill)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    fx = fx[..., None]
    fy = fy[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _affine_inverse(angle, translate, scale, shear, cx, cy):
    """Inverse 3x3 maps of per-sample affine params (batched, degrees).

    Matches torchvision/reference affine composition about the image
    center: T(center) R(angle) Shear Scale T(-center) T(translate)
    (reference cvfunctional.py:744-781).
    """
    a = jnp.deg2rad(angle)
    sh = jnp.deg2rad(shear)
    cos_a = jnp.cos(a)
    sin_a = jnp.sin(a)
    tan_s = jnp.tan(sh)
    B = angle.shape[0]
    # forward M = T(c) * R * Shear * S * T(-c) * T(t);   build inverse directly
    # R*Shear*S =  s*[[cos - sin*tan, -sin], [sin + cos*tan, cos]]
    m00 = scale * (cos_a - sin_a * tan_s)
    m01 = scale * (-sin_a)
    m10 = scale * (sin_a + cos_a * tan_s)
    m11 = scale * cos_a
    det = m00 * m11 - m01 * m10
    i00 = m11 / det
    i01 = -m01 / det
    i10 = -m10 / det
    i11 = m00 / det
    tx, ty = translate[:, 0], translate[:, 1]
    # x_in = A^-1 (x_out - c - t) + c
    ox = cx + tx
    oy = cy + ty
    b0 = cx - (i00 * ox + i01 * oy)
    b1 = cy - (i10 * ox + i11 * oy)
    zeros = jnp.zeros((B,))
    ones = jnp.ones((B,))
    return jnp.stack([
        jnp.stack([i00, i01, b0], -1),
        jnp.stack([i10, i11, b1], -1),
        jnp.stack([zeros, zeros, ones], -1),
    ], axis=1)


def affine(x: jax.Array, angle, translate=(0.0, 0.0), scale=1.0,
           shear=0.0, fill: float = 0.0) -> jax.Array:
    """Batched affine warp (reference cvtransforms RandomAffine kernel,
    cvfunctional.py:744-781).  Scalars broadcast over the batch."""
    B = x.shape[0]
    angle = jnp.broadcast_to(jnp.asarray(angle, jnp.float32), (B,))
    scale = jnp.broadcast_to(jnp.asarray(scale, jnp.float32), (B,))
    shear = jnp.broadcast_to(jnp.asarray(shear, jnp.float32), (B,))
    translate = jnp.broadcast_to(
        jnp.asarray(translate, jnp.float32).reshape(-1, 2)
        if np.ndim(translate) > 1 else jnp.asarray(translate, jnp.float32),
        (B, 2))
    cx = (x.shape[2] - 1) * 0.5
    cy = (x.shape[1] - 1) * 0.5
    inv = _affine_inverse(angle, translate, scale, shear, cx, cy)
    return _warp_bilinear(x, inv, fill)


def rotate(x: jax.Array, angle, fill: float = 0.0) -> jax.Array:
    """Rotate about the image center by ``angle`` degrees (reference
    cvtransforms RandomRotation kernel)."""
    return affine(x, angle, fill=fill)


def _solve_homography(src: jax.Array, dst: jax.Array) -> jax.Array:
    """Per-sample 3x3 homography mapping 4 src points to 4 dst points.

    src/dst: (B, 4, 2) in (col, row).  Standard 8x8 DLT linear system,
    solved batched on device (cv2.getPerspectiveTransform equivalent).
    """
    B = src.shape[0]
    rows = []
    for i in range(4):
        xs, ys = src[:, i, 0], src[:, i, 1]
        xd, yd = dst[:, i, 0], dst[:, i, 1]
        one = jnp.ones((B,))
        zero = jnp.zeros((B,))
        rows.append(jnp.stack(
            [xs, ys, one, zero, zero, zero, -xd * xs, -xd * ys], -1))
        rows.append(jnp.stack(
            [zero, zero, zero, xs, ys, one, -yd * xs, -yd * ys], -1))
    A = jnp.stack(rows, axis=1)                      # (B, 8, 8)
    b = jnp.stack([dst[:, i // 2, i % 2] for i in range(8)], -1)  # x0,y0,...
    h = jnp.linalg.solve(A, b[..., None])[..., 0]    # (B, 8)
    ones = jnp.ones((B, 1))
    return jnp.concatenate([h, ones], -1).reshape(B, 3, 3)


def perspective(x: jax.Array, startpoints: jax.Array, endpoints: jax.Array,
                fill: float = 0.0) -> jax.Array:
    """Batched perspective warp: startpoints -> endpoints, (B, 4, 2) each
    in (col, row) order (reference cvfunctional.py:782-820 semantics)."""
    fwd = _solve_homography(jnp.asarray(startpoints, jnp.float32),
                            jnp.asarray(endpoints, jnp.float32))
    inv = jnp.linalg.inv(fwd)
    return _warp_bilinear(x, inv, fill)


# -- random-parameter wrappers ------------------------------------------------


def random_rotation(key: jax.Array, x: jax.Array, degrees: float,
                    fill: float = 0.0) -> jax.Array:
    a = jax.random.uniform(key, (x.shape[0],), minval=-degrees,
                           maxval=degrees)
    return rotate(x, a, fill=fill)


def random_affine(key: jax.Array, x: jax.Array, degrees: float = 0.0,
                  translate: tuple[float, float] = (0.0, 0.0),
                  scale_range: tuple[float, float] = (1.0, 1.0),
                  shear: float = 0.0, fill: float = 0.0) -> jax.Array:
    """Reference cvtransforms RandomAffine parameter sampling."""
    B, H, W, _ = x.shape
    ka, kt, ks, kh = jax.random.split(key, 4)
    a = jax.random.uniform(ka, (B,), minval=-degrees, maxval=degrees)
    max_t = jnp.asarray([translate[0] * W, translate[1] * H], jnp.float32)
    t = jax.random.uniform(kt, (B, 2), minval=-1.0, maxval=1.0) * max_t
    s = jax.random.uniform(ks, (B,), minval=scale_range[0],
                           maxval=scale_range[1])
    sh = jax.random.uniform(kh, (B,), minval=-shear, maxval=shear)
    return affine(x, a, t, s, sh, fill=fill)


def random_perspective(key: jax.Array, x: jax.Array,
                       distortion_scale: float = 0.5, p: float = 0.5,
                       fill: float = 0.0) -> jax.Array:
    """Reference cvtransforms RandomPerspective: corners jitter inward by
    U(0, d/2) of the half-extent; applied with probability p."""
    B, H, W, _ = x.shape
    kp, kd = jax.random.split(key)
    base = jnp.asarray([[0.0, 0.0], [W - 1.0, 0.0],
                        [W - 1.0, H - 1.0], [0.0, H - 1.0]], jnp.float32)
    base = jnp.broadcast_to(base, (B, 4, 2))
    max_d = jnp.asarray([W, H], jnp.float32) * (distortion_scale / 2.0)
    jitter = jax.random.uniform(kd, (B, 4, 2)) * max_d
    signs = jnp.asarray([[1, 1], [-1, 1], [-1, -1], [1, -1]], jnp.float32)
    end = base + jitter * signs
    warped = perspective(x, base, end, fill=fill)
    apply = jax.random.bernoulli(kp, p, (B, 1, 1, 1))
    return jnp.where(apply, warped, x)


# ---------------------------------------------------------------------------


def compose(*fns):
    """Compose transforms left-to-right.  Random transforms are curried
    with their key by the caller: compose(partial(random_hflip, k), ...)."""
    def run(x):
        for f in fns:
            x = f(x)
        return x
    return run
