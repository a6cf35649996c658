"""Tests for the batched transform library (data/transforms.py).

Geometric warps are checked against a dense per-pixel numpy bilinear
sampler (independent implementation of the cv2 INTER_LINEAR + inverse-map
semantics the reference uses, cvfunctional.py:744-865); photometric ops
against closed-form expectations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dct_cryptonets.data import transforms as tr


def _np_warp(img: np.ndarray, inv: np.ndarray, fill=0.0) -> np.ndarray:
    """Reference inverse-map bilinear warp; img (H, W, C), inv (3, 3)."""
    H, W, C = img.shape
    out = np.full((H, W, C), fill, np.float64)
    for r in range(H):
        for c in range(W):
            x, y, w = inv @ np.array([c, r, 1.0])
            x, y = x / w, y / w
            x0, y0 = int(np.floor(x)), int(np.floor(y))
            fx, fy = x - x0, y - y0
            acc = np.zeros(C)
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    yy, xx = y0 + dy, x0 + dx
                    v = (img[yy, xx] if 0 <= yy < H and 0 <= xx < W
                         else np.full(C, fill))
                    acc += wy * wx * v
            out[r, c] = acc
    return out


def _rand_img(key, n=2, size=12, c=3):
    return jax.random.uniform(key, (n, size, size, c)) * 255.0


class TestGeometric:
    def test_rotate_matches_numpy(self):
        img = _rand_img(jax.random.key(0), n=1)
        angle = 30.0
        got = np.asarray(tr.rotate(img, angle))[0]
        a = np.deg2rad(angle)
        H = W = img.shape[1]
        cx = cy = (W - 1) / 2
        # inverse of a pure center rotation = rotation by -angle
        ca, sa = np.cos(a), np.sin(a)
        inv = np.array([[ca, sa, cx - ca * cx - sa * cy],
                        [-sa, ca, cy + sa * cx - ca * cy],
                        [0, 0, 1.0]])
        want = _np_warp(np.asarray(img[0], np.float64), inv)
        np.testing.assert_allclose(got, want, atol=1e-2)

    def test_rotate_360_identity(self):
        img = _rand_img(jax.random.key(1))
        got = np.asarray(tr.rotate(img, 360.0))
        # interior pixels identical (border taps may read the fill value)
        np.testing.assert_allclose(got[:, 2:-2, 2:-2], img[:, 2:-2, 2:-2],
                                   atol=1e-2)

    def test_affine_translate_only(self):
        img = _rand_img(jax.random.key(2))
        got = np.asarray(tr.affine(img, 0.0, translate=(3.0, 2.0)))
        want = np.zeros_like(got)
        want[:, 2:, 3:] = np.asarray(img)[:, :-2, :-3]
        np.testing.assert_allclose(got, want, atol=1e-3)

    def test_affine_identity_and_scale(self):
        img = _rand_img(jax.random.key(3))
        same = np.asarray(tr.affine(img, 0.0))
        np.testing.assert_allclose(same, np.asarray(img), atol=1e-3)
        # scale=2 about the center: output (6,6) pulls back to (5.75, 5.75)
        up = np.asarray(tr.affine(img, 0.0, scale=2.0))
        src = np.asarray(img)
        f = 0.75
        want = ((1 - f) * (1 - f) * src[:, 5, 5] + (1 - f) * f * src[:, 5, 6]
                + f * (1 - f) * src[:, 6, 5] + f * f * src[:, 6, 6])
        np.testing.assert_allclose(up[:, 6, 6], want, atol=1e-2)

    def test_perspective_identity_and_numpy(self):
        img = _rand_img(jax.random.key(4), n=1)
        H = W = img.shape[1]
        base = np.array([[0, 0], [W - 1.0, 0], [W - 1.0, H - 1.0],
                         [0, H - 1.0]], np.float32)[None]
        same = np.asarray(tr.perspective(img, base, base))
        np.testing.assert_allclose(same, img, atol=1e-2)

        end = base + np.array([[[1.0, 0.5], [-1.0, 0.5],
                                [-0.5, -1.0], [0.5, -1.0]]], np.float32)
        got = np.asarray(tr.perspective(img, base, end))[0]
        fwd = np.asarray(tr._solve_homography(jnp.asarray(base),
                                              jnp.asarray(end)))[0]
        want = _np_warp(np.asarray(img[0], np.float64), np.linalg.inv(fwd))
        np.testing.assert_allclose(got, want, atol=0.5)

    def test_homography_maps_corners(self):
        key = jax.random.key(5)
        src = jax.random.uniform(key, (3, 4, 2)) * 10
        dst = src + jax.random.normal(jax.random.key(6), (3, 4, 2))
        Hm = tr._solve_homography(src, dst)
        pts = jnp.concatenate([src, jnp.ones((3, 4, 1))], -1)
        mapped = jnp.einsum("bij,bpj->bpi", Hm, pts)
        mapped = mapped[..., :2] / mapped[..., 2:]
        np.testing.assert_allclose(np.asarray(mapped), np.asarray(dst),
                                   atol=1e-3)

    def test_random_wrappers_shapes_and_bounds(self):
        img = _rand_img(jax.random.key(7), n=4)
        for fn in (lambda k, x: tr.random_rotation(k, x, 15.0),
                   lambda k, x: tr.random_affine(
                       k, x, 10.0, (0.1, 0.1), (0.9, 1.1), 5.0),
                   lambda k, x: tr.random_perspective(k, x, 0.3, p=1.0)):
            out = fn(jax.random.key(8), img)
            assert out.shape == img.shape
            assert bool(jnp.all(jnp.isfinite(out)))


class TestPhotometric:
    def test_color_jitter_ranges(self):
        img = _rand_img(jax.random.key(9), n=8)
        out = tr.color_jitter(jax.random.key(10), img, 0.4, 0.4, 0.4, 0.1)
        assert out.shape == img.shape
        assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0
        # zero-strength jitter is the identity
        same = tr.color_jitter(jax.random.key(11), img)
        np.testing.assert_allclose(np.asarray(same), np.asarray(img),
                                   atol=1e-4)

    def test_hue_preserves_luma(self):
        # narrow gamut so the rotated chroma never clips at 0/255
        img = _rand_img(jax.random.key(12), n=2) * 0.2 + 100
        out = tr.color_jitter(jax.random.key(13), img, hue=0.2)
        luma_in = np.asarray(tr.grayscale(img, keep_channels=False))
        luma_out = np.asarray(tr.grayscale(out, keep_channels=False))
        np.testing.assert_allclose(luma_out, luma_in, atol=1.5)

    def test_gaussian_noise_stats(self):
        img = jnp.full((2, 64, 64, 3), 128.0)
        out = tr.gaussian_noise(jax.random.key(14), img, std=5.0)
        d = np.asarray(out) - 128.0
        assert abs(d.mean()) < 0.5
        assert abs(d.std() - 5.0) < 0.5

    def test_salt_pepper_fraction(self):
        img = jnp.full((2, 128, 128, 3), 100.0)
        out = np.asarray(tr.salt_pepper_noise(jax.random.key(15), img,
                                              prob=0.1))
        frac_salt = (out == 255.0).all(-1).mean()
        frac_pepper = (out == 0.0).all(-1).mean()
        assert 0.03 < frac_salt < 0.07
        assert 0.03 < frac_pepper < 0.07


class TestSizing:
    def test_random_crop_content(self):
        img = _rand_img(jax.random.key(16), n=3, size=16)
        out = tr.random_crop(jax.random.key(17), img, 8)
        assert out.shape == (3, 8, 8, 3)
        # every crop row must exist somewhere in the source image
        src = np.asarray(img)
        o = np.asarray(out)
        for b in range(3):
            found = any(
                np.allclose(src[b, t:t + 8, l:l + 8], o[b], atol=1e-5)
                for t in range(9) for l in range(9))
            assert found

    def test_flips_and_rescale(self):
        img = _rand_img(jax.random.key(18))
        np.testing.assert_array_equal(
            np.asarray(tr.hflip(tr.hflip(img))), np.asarray(img))
        np.testing.assert_array_equal(
            np.asarray(tr.vflip(tr.vflip(img))), np.asarray(img))
        assert tr.rescale(img, 0.5).shape == (2, 6, 6, 3)
        out = tr.random_hflip(jax.random.key(19), img, p=0.0)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(img))

    def test_pipeline_jits(self):
        """A composed aug pipeline compiles into one jitted function."""
        def pipe(key, x):
            k1, k2, k3 = jax.random.split(key, 3)
            x = tr.random_hflip(k1, x)
            x = tr.random_rotation(k2, x, 10.0)
            x = tr.gaussian_noise(k3, x, std=2.0)
            return x

        img = _rand_img(jax.random.key(20), n=4, size=16)
        out = jax.jit(pipe)(jax.random.key(21), img)
        assert out.shape == img.shape


class TestRgbIngest:
    """RGB (non-DCT) train/eval ingest — reference datamgr.py:69-90 recipe
    (RandomResizedCrop + per-dataset jitter + hflip for aug=True;
    Resize 1.15x + CenterCrop for aug=False; Normalize both)."""

    def test_train_aug_changes_batch_eval_does_not(self):
        from dct_cryptonets.data.codec import rgb_ingest, rgb_ingest_train
        rng = np.random.default_rng(3)
        imgs = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
        e1 = np.asarray(rgb_ingest(jnp.asarray(imgs), 32))
        e2 = np.asarray(rgb_ingest(jnp.asarray(imgs), 32))
        np.testing.assert_array_equal(e1, e2)          # eval: deterministic
        t1 = np.asarray(rgb_ingest_train(jax.random.key(0),
                                         jnp.asarray(imgs), 32, "cifar10"))
        t2 = np.asarray(rgb_ingest_train(jax.random.key(1),
                                         jnp.asarray(imgs), 32, "cifar10"))
        assert t1.shape == e1.shape == (4, 32, 32, 3)
        assert not np.array_equal(t1, e1)              # aug changed pixels
        assert not np.array_equal(t1, t2)              # key-dependent

    def test_normalization_stats_per_dataset(self):
        from dct_cryptonets.data.codec import RGB_STATS, rgb_normalize
        x = jnp.full((1, 2, 2, 3), 128.0)
        for name in ("cifar10", "imagenet"):
            mean, std = RGB_STATS.get(name, RGB_STATS["default"])
            want = (128.0 - np.asarray(mean) * 255) / (np.asarray(std) * 255)
            got = np.asarray(rgb_normalize(x, name))[0, 0, 0]
            np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_jitter_strength_follows_reference(self):
        from dct_cryptonets.data.codec import rgb_jitter_param
        assert rgb_jitter_param("cifar10") == 0.1   # homomorphic_eval.py:108
        assert rgb_jitter_param("Imagenet") == 0.4  # datamgr.py:38-42 default
