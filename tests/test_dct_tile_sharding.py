"""DCT-tile parallelism: sharded ingest == unsharded ingest, bit-exact.

SURVEY §2.3 names DCT-tile sharding as this workload's sequence-parallel
analog: shard an image's 8x8-block grid across devices, all-gather the
selected low-frequency channels.  ``dct_ingest_sharded`` implements it;
these tests pin bit-exactness against the plain ``dct_ingest`` on the
8-device virtual CPU mesh, including the B=1 case (one image's block grid
spread over the whole mesh — where batch DP has nothing to shard).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from dct_cryptonets.data import CodecConfig, dct_ingest, dct_ingest_sharded
from dct_cryptonets.parallel import data_mesh


def _images(b, size, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 256, (b, size, size, 3), np.uint8))


@pytest.mark.parametrize("b", [1, 4])
def test_fs4_flagship_sharded_matches_unsharded(b):
    """Flagship config (fs=4, 24 ch, 16^2): float einsum path."""
    cfg = CodecConfig(channels=24, filter_size=4, image_size_dct=16)
    mesh = data_mesh(8)
    imgs = _images(b, 80, seed=b)          # exercises the resize prologue
    ref = np.asarray(dct_ingest(imgs, cfg))
    got = np.asarray(dct_ingest_sharded(imgs, cfg, mesh))
    np.testing.assert_array_equal(got, ref)


def test_fs8_jpeg_sharded_matches_unsharded():
    """fs=8 (libjpeg integer path): pure int ops, sharded == unsharded."""
    cfg = CodecConfig(channels=24, filter_size=8, image_size_dct=16)
    mesh = data_mesh(8)
    imgs = _images(2, 144, seed=7)
    ref = np.asarray(dct_ingest(imgs, cfg))
    got = np.asarray(dct_ingest_sharded(imgs, cfg, mesh))
    np.testing.assert_array_equal(got, ref)


def test_single_image_padding_path_on_odd_mesh():
    """B=1 on a 3-device mesh: one image's 256-tile Y grid is not a mesh
    multiple, so the tile axis takes the pad-to-multiple path."""
    cfg = CodecConfig(channels=24, filter_size=4, image_size_dct=16)
    mesh = data_mesh(3)
    imgs = _images(1, 80, seed=3)
    ref = np.asarray(dct_ingest(imgs, cfg))
    got = np.asarray(dct_ingest_sharded(imgs, cfg, mesh))
    np.testing.assert_array_equal(got, ref)
