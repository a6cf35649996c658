"""Batched on-device DCT ingest pipeline.

The reference runs its codec per-sample in 4-8 DataLoader worker processes
(libjpeg-turbo / jpeg2dct / OpenCV; reference data/datamgr.py:150-220,
data/cvfunctional.py:21-74).  Here the *entire* pipeline is a single jittable
JAX function over a uint8 image batch, so it runs on-device, fuses into the
training step, and batches the per-tile DCTs into matrix products:

    uint8 RGB (B, H, W, 3)
      -> resize(1.15 * fs * S) -> center-crop(fs * S)          [eval path]
      -> YCbCr split + 2x chroma downsample
      -> blockwise S x S orthonormal DCT-II  (ops.dct, batched matmuls)
      -> bilinear upscale of coefficient maps to (S, S)
      -> low-frequency channel subset (tables.subset_indices)
      -> concat Y|Cb|Cr -> per-channel normalization (tables.normalization_stats)
      -> float32 (B, S, S, C)   [NHWC]

Two chroma conventions are matched to the reference:
  * ``filter_size != 8`` (manual path, cvfunctional.py:59-74): OpenCV YCrCb
    coefficients; NOTE the reference splits YCrCb as ``y, cb, cr`` so its
    "cb" is actually Cr — we reproduce that swap.
  * ``filter_size == 8`` (JPEG path, cvfunctional.py:21-26): the full
    libjpeg integer forward path — fixed-point color conversion with the
    TJPF_BGR-on-RGB channel swap, biased h2v2 4:2:0 downsample, islow FDCT,
    quality-100 quantization (ops/jpegdct.py; golden-pinned vs libjpeg).
"""
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.dct import blockwise_dct2
from ..ops.jpegdct import jpeg_q100_coefficients
from .tables import normalization_stats, subset_indices


@dataclass(frozen=True)
class CodecConfig:
    """Static configuration of the DCT ingest pipeline.

    Field names mirror the reference CLI flags (io_utils.py:33-42).
    """
    channels: int = 24          # low-frequency channel budget across Y/Cb/Cr
    filter_size: int = 4        # DCT tile size S_f
    image_size_dct: int = 16    # spatial size S of the coefficient maps
    dct_pattern: str = "default"

    @property
    def pixel_size(self) -> int:
        return self.filter_size * self.image_size_dct

    def subset(self):
        return subset_indices(self.channels, self.dct_pattern, self.filter_size)

    def stats(self):
        return normalization_stats(self.channels)


# ---------------------------------------------------------------------------
# color conversion


def rgb_to_ycrcb_cv(x: jax.Array) -> jax.Array:
    """OpenCV RGB -> (Y, Cr, Cb), BIT-EXACT vs cv2.cvtColor's fixed-point.

    cv2's 8U color conversion is 14-bit fixed point (modules/imgproc
    color_yuv): Y = descale(R*4899 + G*9617 + B*1868), Cr = descale((R-Y)
    * 11682) + 128, Cb = descale((B-Y) * 9241) + 128 with descale(v) =
    (v + 2^13) >> 14 — NOT the float formula rounded (the two differ by
    +-1 on ~1/2^? of pixels, which the golden parity test
    (tests/test_codec_golden.py) shows matters after per-channel
    normalization).  Matches the reference's
    cv2.cvtColor(BGR, COLOR_BGR2YCrCb) after its RGB->BGR flip
    (cvfunctional.py:63-66).
    """
    xi = x.astype(jnp.int32)
    r, g, b = xi[..., 0], xi[..., 1], xi[..., 2]

    def descale(v):
        return (v + (1 << 13)) >> 14

    y = descale(r * 4899 + g * 9617 + b * 1868)
    cr = descale((r - y) * 11682) + 128
    cb = descale((b - y) * 9241) + 128
    out = jnp.stack([y, cr, cb], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.float32)


# ---------------------------------------------------------------------------
# spatial ops (cv2-bilinear semantics: half-pixel centers, no antialias)


def resize_bilinear(x: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """FLOAT bilinear resize with half-pixel centers (cv2 float path).

    Used for float coefficient maps (UpScaleDCT); uint8 PIXEL stages must
    go through :func:`resize_linear_u8_cv` to reproduce cv2's fixed-point
    arithmetic exactly."""
    shape = (*x.shape[:-3], out_h, out_w, x.shape[-1])
    return jax.image.resize(x.astype(jnp.float32), shape, method="linear",
                            antialias=False)


def _cv2_linear_plan(src: int, dst: int):
    """cv2 INTER_LINEAR 8U coefficient plan for one axis (resize.cpp).

    Returns static numpy arrays (i0, i1, a0, a1): output pixel d reads
    src pixels i0[d], i1[d] with int16 weights a0, a1 at scale 2^11.
    Weights are quantized with cvRound (round-half-to-even), exactly as
    ``saturate_cast<short>((1-f) * INTER_RESIZE_COEF_SCALE)`` does.
    """
    scale = src / dst
    d = np.arange(dst)
    fx = (d + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx[sx < 0] = 0.0
    sx[sx < 0] = 0
    fx[sx >= src - 1] = 0.0
    sx[sx >= src - 1] = src - 1
    a1 = np.rint(fx * 2048.0).astype(np.int32)
    a0 = np.rint((1.0 - fx) * 2048.0).astype(np.int32)
    i0 = sx
    i1 = np.minimum(sx + 1, src - 1)
    return i0, i1, a0, a1


def resize_linear_u8_cv(x: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """cv2.resize(..., INTER_LINEAR) on uint8 planes, BIT-EXACT.

    cv2's 8U bilinear is fixed point: 2^11-scaled int16 weights
    (cvRound-quantized), an int32 horizontal pass, and a vertical combine
    ``(b0*r0 + b1*r1 + 2^21) >> 22`` (FixedPtCast).  The float-then-round
    shortcut differs by +-1 at exact .5 ties (numpy rounds half-to-even,
    cv2's cast rounds half-up) — enough to shift low-variance chroma DCT
    channels visibly after normalization.

    The vertical combine follows cv2's 8U *specialization* (resize.cpp,
    ``VResizeLinear<uchar, int, short, ...>``):
    ``uchar((((b0*(r0 >> 4)) >> 16) + ((b1*(r1 >> 4)) >> 16) + 2) >> 2)``
    — pre-truncated rows and floor shifts, NOT the generic
    ``(v + 2^21) >> 22`` cast (they differ by +-1 on ~12% of pixels).

    The sparse taps become THREE small f32 matmuls (horizontal weight
    matrix, then two one-hot row selections — the two vertical taps must
    stay separate because each is floor-shifted before the sum), run at
    ``Precision.HIGHEST`` (full f32, no TF32).  All products stay below
    2^24 so f32 is exact, and nothing lowers to a gather.

    x: (..., H, W) integer-valued plane; returns float32 (..., out_h, out_w)
    with exact uint8 values.
    """
    H, W = x.shape[-2], x.shape[-1]
    xf = x.astype(jnp.float32)
    j0, j1, c0, c1 = _cv2_linear_plan(W, out_w)
    A = np.zeros((W, out_w), np.float32)                 # horizontal taps
    np.add.at(A, (j0, np.arange(out_w)), c0.astype(np.float32))
    np.add.at(A, (j1, np.arange(out_w)), c1.astype(np.float32))
    # rows <= 255 * 2049 < 2^19 — exact in f32
    rows = jnp.matmul(xf, jnp.asarray(A),
                      precision=jax.lax.Precision.HIGHEST)
    rows = rows.astype(jnp.int32) >> 4                   # cv2's r >> 4
    i0, i1, b0, b1 = _cv2_linear_plan(H, out_h)
    S0 = np.zeros((out_h, H), np.float32)                # one-hot row picks
    S1 = np.zeros((out_h, H), np.float32)
    S0[np.arange(out_h), i0] = 1.0
    S1[np.arange(out_h), i1] = 1.0
    rf = rows.astype(jnp.float32)                        # < 2^15 — exact
    r0 = jnp.matmul(jnp.asarray(S0), rf,
                    precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
    r1 = jnp.matmul(jnp.asarray(S1), rf,
                    precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
    t0 = (r0 * jnp.asarray(b0)[:, None]) >> 16
    t1 = (r1 * jnp.asarray(b1)[:, None]) >> 16
    out = (t0 + t1 + 2) >> 2
    return jnp.clip(out, 0, 255).astype(jnp.float32)


def center_crop(x: jax.Array, size: int) -> jax.Array:
    """Center crop with the reference's offset arithmetic: ``int(round((h -
    th) * 0.5))`` under Python's round-half-to-even (cvfunctional.py:358-369)
    — differs from ``(h - size) // 2`` when (h - size) is odd with an even
    half above it."""
    h, w = x.shape[-3], x.shape[-2]
    top = int(np.round((h - size) * 0.5))
    left = int(np.round((w - size) * 0.5))
    return x[..., top:top + size, left:left + size, :]


# ---------------------------------------------------------------------------
# core: pixels -> normalized DCT tensor


def _upscale_coeffs_i16(c: jax.Array, S: int) -> jax.Array:
    """UpScaleDCT on int16 coefficient maps, cv2 semantics (the fs=8 path).

    The reference resizes jpeg2dct's int16 arrays directly
    (cvtransforms.py:56-64); cv2's 16S INTER_LINEAR path is float
    accumulation + ``saturate_cast<short>`` (cvRound, half-to-even) — i.e.
    float bilinear then round-half-even, unlike the 8U fixed-point pixel
    path."""
    if c.shape[-3] == S and c.shape[-2] == S:
        return c.astype(jnp.float32)
    return jnp.round(resize_bilinear(c.astype(jnp.float32), S, S))


def _component_coeffs(plane: jax.Array, cfg: CodecConfig, rounded: bool) -> jax.Array:
    """(B, H, W) pixel plane -> (B, S, S, S_f^2) upscaled coefficient maps."""
    c = blockwise_dct2(plane, cfg.filter_size, level_shift=True,
                       round_coeffs=rounded)              # (B, nh, nw, S_f^2)
    S = cfg.image_size_dct
    if c.shape[-3] != S or c.shape[-2] != S:
        # UpScaleDCT (reference cvtransforms.py:56-64): bilinear resize of the
        # coefficient maps themselves to the common (S, S) spatial grid.
        c = resize_bilinear(c, S, S)
    return c


def dct_from_pixels(cropped: jax.Array, cfg: CodecConfig) -> jax.Array:
    """uint8 RGB (B, P, P, 3), P = filter_size * S -> normalized (B, S, S, C).

    Implements GetDCT -> UpScaleDCT -> SubsetDCT -> Aggregate -> NormalizeDCT
    (reference datamgr.py:193-220) as one fused batched function.
    """
    if cfg.filter_size == 8:
        # BIT-EXACT libjpeg q100 forward path (ops/jpegdct.py): fixed-point
        # color conversion (with the reference's TJPF_BGR-on-RGB channel
        # swap), biased h2v2 chroma downsample, integer islow FDCT, and
        # round-half-away quantization by 8 — golden-pinned against the
        # real libjpeg encoder (tests/test_codec_golden.py, fs=8).
        cy, ccb, ccr = jpeg_q100_coefficients(cropped)
        S = cfg.image_size_dct
        coeff_y = _upscale_coeffs_i16(cy, S)
        coeff_cb = _upscale_coeffs_i16(ccb, S)
        coeff_cr = _upscale_coeffs_i16(ccr, S)
    else:
        ycc = rgb_to_ycrcb_cv(cropped)
        y = ycc[..., 0]
        # Reference quirk (cvfunctional.py:66): `y, cb, cr = cv2.split(YCrCb)`
        # binds Cr to the "cb" slot.  Chroma is halved with cv2's exact
        # fixed-point INTER_LINEAR (cvfunctional.py:67-68).
        hh = cropped.shape[-3] // 2
        hw = cropped.shape[-2] // 2
        cb = resize_linear_u8_cv(ycc[..., 1], hh, hw)
        cr = resize_linear_u8_cv(ycc[..., 2], hh, hw)

        coeff_y = _component_coeffs(y, cfg, False)
        coeff_cb = _component_coeffs(cb, cfg, False)
        coeff_cr = _component_coeffs(cr, cfg, False)

    y_idx, cb_idx, cr_idx = cfg.subset()
    parts = [
        coeff_y[..., jnp.asarray(y_idx)],
        coeff_cb[..., jnp.asarray(cb_idx)],
        coeff_cr[..., jnp.asarray(cr_idx)],
    ]
    agg = jnp.concatenate(parts, axis=-1)                  # (B, S, S, C)

    mean, std = cfg.stats()
    return (agg - jnp.asarray(mean)) / jnp.asarray(std)


def _eval_resize_crop(images_u8: jax.Array, P: int) -> jax.Array:
    """Resize(1.15 P, shorter edge) -> CenterCrop(P), the aug=False pixel
    prologue (reference datamgr.py:193-220, cvfunctional.py:204-239) with
    cv2's exact fixed-point 8U bilinear."""
    rs = int(P * 1.15)
    H, W = images_u8.shape[-3], images_u8.shape[-2]
    if not ((W <= H and W == rs) or (H <= W and H == rs)):
        if W < H:
            oh, ow = int(rs * H / W), rs
        else:
            oh, ow = rs, int(rs * W / H)
        planes = jnp.moveaxis(images_u8, -1, -3)       # (..., 3, H, W)
        planes = resize_linear_u8_cv(planes, oh, ow)
        images_u8 = jnp.moveaxis(planes, -3, -1)
    return center_crop(images_u8, P)


@partial(jax.jit, static_argnums=1)
def dct_ingest(images_u8: jax.Array, cfg: CodecConfig) -> jax.Array:
    """Eval-path ingest: Resize(1.15 P) -> CenterCrop(P) -> DCT pipeline.

    Mirrors the aug=False composed transform (reference datamgr.py:193-220).
    ``images_u8``: uint8 RGB, (B, H, W, 3).  Returns float32 (B, S, S, C).
    """
    x = _eval_resize_crop(images_u8, cfg.pixel_size)
    return dct_from_pixels(x, cfg)


@partial(jax.jit, static_argnums=(1, 2, 3))
def dct_ingest_sharded(images_u8: jax.Array, cfg: CodecConfig, mesh,
                       axis_name: str = "data") -> jax.Array:
    """DCT-tile-parallel eval ingest — SURVEY §2.3's sequence-parallel
    analog for this workload.

    The S_f x S_f block grid of the batch (all images' tiles flattened, so
    a SINGLE 224^2 image's 28x28 Y-block grid spreads across the mesh —
    the B=1 encrypted-eval case where plain batch DP has nothing to shard)
    is sharded across ``mesh``; each device computes the forward DCTs of
    its tile shard and selects the static low-frequency channel subset,
    and ONLY the selected channels are all-gathered between devices
    (``channels``/192 of the full coefficient volume — e.g. 1/3 for the
    ImageNet 64-channel config, reference cvtransforms.py:1600-1912).  The
    elementwise pixel prologue (resize/crop, color conversion, chroma
    downsample) and the small upscale/normalize epilogue stay replicated:
    the per-tile DCT transforms carry the FLOPs and are what shards.

    Bit-exact vs :func:`dct_ingest` (tests/test_dct_tile_sharding.py):
    the fs=8 path is pure integer arithmetic; the fs!=8 path runs the
    identical per-tile einsum, and channel subsetting commutes exactly
    with the per-channel upscale.
    """
    from jax import shard_map as _shard_map
    from jax.sharding import PartitionSpec as Spec

    n_dev = int(np.prod(mesh.devices.shape))
    S = cfg.image_size_dct
    S_f = cfg.filter_size
    y_idx, cb_idx, cr_idx = cfg.subset()

    x = _eval_resize_crop(images_u8, cfg.pixel_size)
    if S_f == 8:
        from ..ops.jpegdct import (fdct_islow_q100_tiles, h2v2_downsample,
                                   rgb_to_ycbcr_libjpeg)
        y, cb, cr = rgb_to_ycbcr_libjpeg(x)
        cb = h2v2_downsample(cb)
        cr = h2v2_downsample(cr)

        def tile_fn(tiles):
            return fdct_islow_q100_tiles(tiles)

        def post(c):
            return _upscale_coeffs_i16(c, S)
    else:
        ycc = rgb_to_ycrcb_cv(x)
        y = ycc[..., 0]
        hh, hw = x.shape[-3] // 2, x.shape[-2] // 2
        cb = resize_linear_u8_cv(ycc[..., 1], hh, hw)
        cr = resize_linear_u8_cv(ycc[..., 2], hh, hw)

        def tile_fn(tiles):
            c = blockwise_dct2(tiles, S_f)           # (T, 1, 1, S_f^2)
            return c.reshape(c.shape[0], S_f * S_f)

        def post(c):
            if c.shape[-3] != S or c.shape[-2] != S:
                c = resize_bilinear(c, S, S)
            return c

    def component(plane, idx):
        B, H, W = plane.shape
        nh, nw = H // S_f, W // S_f
        tiles = plane.reshape(B, nh, S_f, nw, S_f)
        tiles = jnp.moveaxis(tiles, -3, -2).reshape(B * nh * nw, S_f, S_f)
        t = tiles.shape[0]
        pad = (-t) % n_dev
        if pad:
            tiles = jnp.concatenate(
                [tiles, jnp.zeros((pad, S_f, S_f), tiles.dtype)], axis=0)
        idx_a = jnp.asarray(idx)

        def local(tl):
            c = tile_fn(tl)[:, idx_a]
            # the one collective: selected low-freq channels
            return jax.lax.all_gather(c, axis_name, axis=0, tiled=True)

        try:
            # check_vma=False: the all_gather output is replicated by
            # construction, which the static VMA check cannot infer
            smapped = _shard_map(local, mesh=mesh, in_specs=Spec(axis_name),
                                 out_specs=Spec(), check_vma=False)
        except TypeError:                            # older JAX: check_rep
            smapped = _shard_map(local, mesh=mesh, in_specs=Spec(axis_name),
                                 out_specs=Spec(), check_rep=False)
        out = smapped(tiles)
        return post(out[:t].reshape(B, nh, nw, len(idx)))

    agg = jnp.concatenate([component(y, y_idx), component(cb, cb_idx),
                           component(cr, cr_idx)], axis=-1)
    mean, std = cfg.stats()
    return (agg - jnp.asarray(mean)) / jnp.asarray(std)


# ---------------------------------------------------------------------------
# training-path ingest with batched augmentation


def _random_resized_crop(key, images, out_size, scale=(0.08, 1.0),
                         ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """Batched RandomResizedCrop via jax.image.scale_and_translate.

    Behavioral equivalent of reference cvtransforms RandomResizedCrop
    (cvtransforms.py, torchvision semantics): sample area in `scale`,
    log-uniform aspect in `ratio`, crop, resize to (out_size, out_size).
    Dynamic crop boxes are handled with static shapes by folding the crop
    into a scale-and-translate, which XLA lowers to a dense gather/matmul.
    """
    B, H, W, C = images.shape
    k1, k2, k3, k4 = jax.random.split(key, 4)
    area = jax.random.uniform(k1, (B,), minval=scale[0], maxval=scale[1]) * (H * W)
    log_r = jax.random.uniform(k2, (B,), minval=np.log(ratio[0]), maxval=np.log(ratio[1]))
    r = jnp.exp(log_r)
    w = jnp.sqrt(area * r)
    h = jnp.sqrt(area / r)
    w = jnp.clip(w, 1.0, W)
    h = jnp.clip(h, 1.0, H)
    top = jax.random.uniform(k3, (B,)) * (H - h)
    left = jax.random.uniform(k4, (B,)) * (W - w)

    def one(img, h, w, top, left):
        sy = out_size / h
        sx = out_size / w
        return jax.image.scale_and_translate(
            img.astype(jnp.float32),
            (out_size, out_size, C),
            (0, 1),
            jnp.stack([sy, sx]),
            jnp.stack([-top * sy, -left * sx]),
            method="linear",
            antialias=False,
        )
    return jax.vmap(one)(images, h, w, top, left)


def _image_jitter(key, x, brightness=0.4, contrast=0.4, color=0.4):
    """Batched brightness/contrast/saturation jitter.

    Matches reference ImageJitter's enhancer order — Brightness, Contrast,
    Color, its transformdict iteration order (cvtransforms.py, PIL
    enhancers with factor = alpha * U(-1, 1) + 1); each stage measures its
    gray statistics on the image produced by the previous stage, like the
    PIL enhancers do.  x: float (B, H, W, 3).
    """
    B = x.shape[0]
    kb, kc, ks = jax.random.split(key, 3)
    fb = 1.0 + brightness * (jax.random.uniform(kb, (B, 1, 1, 1)) * 2 - 1)
    fc = 1.0 + contrast * (jax.random.uniform(kc, (B, 1, 1, 1)) * 2 - 1)
    fs = 1.0 + color * (jax.random.uniform(ks, (B, 1, 1, 1)) * 2 - 1)

    def gray_of(img):
        return (0.299 * img[..., 0] + 0.587 * img[..., 1]
                + 0.114 * img[..., 2])[..., None]

    x = x * fb                                      # brightness
    mean = gray_of(x).mean(axis=(1, 2), keepdims=True)
    x = mean + (x - mean) * fc                      # contrast
    gray = gray_of(x)
    x = gray + (x - gray) * fs                      # saturation ("Color")
    return jnp.clip(x, 0, 255)


# RGB (non-DCT) normalization stats: the reference uses CIFAR stats + 0.1
# jitter for cifar10 RGB and ImageNet stats + 0.4 jitter otherwise
# (reference homomorphic_eval.py:100-111, datamgr.py:26-42)
RGB_STATS = {
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "default": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def rgb_jitter_param(dataset: str) -> float:
    """0.1 for cifar10 RGB, 0.4 (the datamgr default) otherwise
    (reference homomorphic_eval.py:102-111, datamgr.py:38-42)."""
    return 0.1 if dataset == "cifar10" else 0.4


def rgb_normalize(x: jax.Array, dataset: str = "cifar10") -> jax.Array:
    """ToTensor + Normalize for the RGB path; input is 0..255 float/uint8."""
    mean, std = RGB_STATS.get(dataset, RGB_STATS["default"])
    mean = jnp.asarray(mean) * 255.0
    std = jnp.asarray(std) * 255.0
    return (jnp.asarray(x, jnp.float32) - mean) / std


@partial(jax.jit, static_argnums=(1, 2))
def rgb_ingest(images_u8: jax.Array, image_size: int,
               dataset: str = "cifar10") -> jax.Array:
    """RGB eval-path ingest: Resize(1.15x) -> CenterCrop -> Normalize.

    Mirrors the reference's aug=False RGB composed transform
    (datamgr.py:82-90: Resize([int(size*1.15)]*2), CenterCrop(size),
    ToTensor, Normalize)."""
    big = int(image_size * 1.15)
    x = resize_bilinear(jnp.asarray(images_u8, jnp.float32), big, big)
    x = center_crop(x, image_size)
    return rgb_normalize(x, dataset)


@partial(jax.jit, static_argnums=(2, 3))
def rgb_ingest_train(key: jax.Array, images_u8: jax.Array, image_size: int,
                     dataset: str = "cifar10") -> jax.Array:
    """RGB train-path ingest: RandomResizedCrop -> jitter -> hflip ->
    Normalize (reference datamgr.py:69-80 aug=True list; jitter strength
    per dataset, homomorphic_eval.py:102-111)."""
    j = rgb_jitter_param(dataset)
    kc, kj, kf = jax.random.split(key, 3)
    x = _random_resized_crop(kc, images_u8, image_size)
    x = _image_jitter(kj, x, brightness=j, contrast=j, color=j)
    flip = jax.random.bernoulli(kf, 0.5, (x.shape[0], 1, 1, 1))
    x = jnp.where(flip, x[:, :, ::-1, :], x)
    x = jnp.clip(jnp.round(x), 0, 255)
    return rgb_normalize(x, dataset)


@partial(jax.jit, static_argnums=2)
def dct_ingest_train(key: jax.Array, images_u8: jax.Array, cfg: CodecConfig) -> jax.Array:
    """Train-path ingest: RandomResizedCrop(P) -> jitter -> hflip -> DCT.

    Mirrors the aug=True composed transform (reference datamgr.py:150-191).
    """
    P = cfg.pixel_size
    kc, kj, kf = jax.random.split(key, 3)
    x = _random_resized_crop(kc, images_u8, P)
    x = _image_jitter(kj, x)
    flip = jax.random.bernoulli(kf, 0.5, (x.shape[0], 1, 1, 1))
    x = jnp.where(flip, x[:, :, ::-1, :], x)
    x = jnp.clip(jnp.round(x), 0, 255)
    return dct_from_pixels(x, cfg)
