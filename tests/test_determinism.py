"""Determinism + CSPRNG contract tests (SURVEY §5: same seed -> same
ciphertext stands in for race detection in an SPMD framework)."""
import numpy as np
import pytest

from dct_cryptonets.fhe import torus as T
from dct_cryptonets.fhe.keys import (Csprng, encrypt_lwe, keygen,
                                         make_server_keys)
from dct_cryptonets.fhe.params import TEST_PARAMS


def test_csprng_deterministic_and_seed_sensitive():
    a = Csprng(7).integers(0, 1 << 63, 64)
    b = Csprng(7).integers(0, 1 << 63, 64)
    c = Csprng(8).integers(0, 1 << 63, 64)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # entropy mode: two unseeded streams differ
    assert not np.array_equal(Csprng(None).integers(0, 1 << 63, 64),
                              Csprng(None).integers(0, 1 << 63, 64))


def test_csprng_statistics():
    r = Csprng(0)
    bits = r.integers(0, 2, 20000)
    assert 0.47 < bits.mean() < 0.53
    z = r.normal(0.0, 1.0, 20001)   # odd size exercises the pairing path
    assert abs(z.mean()) < 0.05 and 0.95 < z.std() < 1.05
    with pytest.raises(ValueError):
        r.integers(0, 3, 4)          # non-power-of-two span is refused


def test_keygen_deterministic():
    k1 = keygen(TEST_PARAMS, seed=3)
    k2 = keygen(TEST_PARAMS, seed=3)
    assert np.array_equal(k1.lwe_key, k2.lwe_key)
    assert np.array_equal(k1.glwe_key, k2.glwe_key)
    sk1 = make_server_keys(k1, seed=4)
    sk2 = make_server_keys(k2, seed=4)
    assert np.array_equal(sk1.bsk, sk2.bsk)
    assert np.array_equal(sk1.ksk, sk2.ksk)
    assert not np.array_equal(keygen(TEST_PARAMS, seed=5).lwe_key, k1.lwe_key)


def test_same_seed_same_ciphertext():
    ck = keygen(TEST_PARAMS, seed=0)
    mu = (np.arange(8, dtype=np.uint64) << np.uint64(60))
    c1 = encrypt_lwe(ck, mu, Csprng(11))
    c2 = encrypt_lwe(ck, mu, Csprng(11))
    c3 = encrypt_lwe(ck, mu, Csprng(12))
    assert np.array_equal(c1, c2)
    assert not np.array_equal(c1, c3)


def test_module_encrypt_seeded_determinism():
    """CompiledModule.encrypt with an explicit Csprng is reproducible;
    without one, masks are fresh entropy (still decrypt correctly)."""
    from dct_cryptonets.fhe.circuit import Circuit, Output, QuantIn
    from dct_cryptonets.fhe.runtime import CompiledModule

    circ = Circuit([QuantIn(0.5, 4, 6, "x0"), Output("x0", 0.5)],
                   (1, 1, 4), {"x0": 6}, {"shapes": {"x0": (1, 1, 4)}})
    mod = CompiledModule(circ, TEST_PARAMS)
    mod.client_keys = keygen(TEST_PARAMS, seed=0)
    x = np.asarray([[[[1.0, -2.0, 3.0, -0.5]]]], np.float32)
    e1 = mod.encrypt(x, rng=Csprng(42))
    e2 = mod.encrypt(x, rng=Csprng(42))
    assert np.array_equal(T.to_u64(e1), T.to_u64(e2))
    e3 = mod.encrypt(x)
    e4 = mod.encrypt(x)
    assert not np.array_equal(T.to_u64(e3), T.to_u64(e4))
    # all decrypt to the same features
    f1 = mod.decrypt_feats(e1)
    f3 = mod.decrypt_feats(e3)
    np.testing.assert_allclose(f1, f3)


def test_lazy_manifest(tmp_path):
    """ManifestDataset decodes images per batch, not at construction."""
    import json
    from PIL import Image
    from dct_cryptonets.data.pipeline import load_json_manifest

    names, labels = [], []
    for i in range(4):
        p = tmp_path / f"im{i}.png"
        Image.fromarray(np.full((8, 8, 3), i * 10, np.uint8)).save(p)
        names.append(str(p))
        labels.append(i % 2)
    # one bogus path: construction must NOT touch it (lazy), gather of the
    # other entries must work
    names.append(str(tmp_path / "missing.png"))
    labels.append(0)
    mpath = tmp_path / "manifest.json"
    mpath.write_text(json.dumps({"image_names": names,
                                 "image_labels": labels}))
    ds = load_json_manifest(str(mpath), image_size=8)
    assert len(ds) == 5
    imgs, labs = ds.gather(np.asarray([0, 2]))
    assert imgs.shape == (2, 8, 8, 3) and imgs.dtype == np.uint8
    assert imgs[1, 0, 0, 0] == 20
    assert list(labs) == [0, 0]
