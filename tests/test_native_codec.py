"""Native C++ host codec vs the on-device JAX codec (bit-level parity)."""
import numpy as np
import pytest
import jax.numpy as jnp

from dct_cryptonets.data.codec import CodecConfig, dct_from_pixels
from dct_cryptonets.data import native
from dct_cryptonets.ops.dct import blockwise_dct2

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="native codec not built")


def test_blockwise_dct_native_matches_jax():
    rng = np.random.default_rng(0)
    plane = rng.integers(0, 256, (32, 32)).astype(np.float32)
    got = native.blockwise_dct_native(plane, 4)
    want = np.asarray(blockwise_dct2(jnp.asarray(plane), 4))
    np.testing.assert_allclose(got, want, atol=1e-2)


@pytest.mark.parametrize("fs,S,ch", [(4, 16, 24), (8, 8, 24)])
def test_ingest_native_matches_device_codec(fs, S, ch):
    cfg = CodecConfig(channels=ch, filter_size=fs, image_size_dct=S)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (3, cfg.pixel_size, cfg.pixel_size, 3)
                        ).astype(np.uint8)
    got = native.dct_ingest_native(imgs, cfg)
    want = np.asarray(dct_from_pixels(jnp.asarray(imgs), cfg))
    assert got.shape == want.shape
    # The C++ path computes color conversion in double, the JAX path in f32;
    # pixels landing exactly on .5 rounding ties can flip by one level and
    # ripple into a handful of coefficients.  Require tight agreement on
    # 99.5% of elements and bounded deviation everywhere.
    diff = np.abs(got - want)
    assert (diff < 5e-2).mean() > 0.99, (diff < 5e-2).mean()
    assert diff.max() < 2.0, diff.max()
