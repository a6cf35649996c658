"""Dataset loaders: digits (real data), lazy ImageFolder, gather batching."""
import numpy as np
import pytest

from dct_cryptonets.data import pipeline


def test_digits_loader_real_data():
    tr = pipeline.get_dataset("digits", None, True, image_size=32)
    te = pipeline.get_dataset("digits", None, False, image_size=32)
    assert tr.images.shape[1:] == (32, 32, 3) and tr.images.dtype == np.uint8
    assert len(tr) + len(te) == 1797          # the full sklearn digits set
    assert set(np.unique(te.labels)) <= set(range(10))
    # split is seeded (rs=42 parity with the reference's subset semantics)
    tr2 = pipeline.get_dataset("digits", None, True, image_size=32)
    np.testing.assert_array_equal(tr.labels, tr2.labels)


@pytest.mark.parametrize("n,test_size,seed,train,test", [
    (20, 0.25, 42, [5, 11, 3, 18, 16, 13, 2, 9, 19, 4, 12, 7, 10, 14, 6],
     [0, 17, 15, 1, 8]),
    (20, 3, 7, [5, 11, 0, 18, 6, 13, 19, 10, 14, 8, 16, 9, 12, 7, 3, 4, 15],
     [1, 17, 2]),
])
def test_train_val_split_matches_sklearn(n, test_size, seed, train, test):
    """Indices as sklearn's train_test_split(np.arange(n), ...) gives them
    (expected values recorded from scikit-learn 1.9)."""
    tr, te = pipeline.train_val_split(n, test_size, random_state=seed)
    np.testing.assert_array_equal(tr, train)
    np.testing.assert_array_equal(te, test)


def test_folder_dataset_lazy(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    for ci, cls in enumerate(["alpha", "beta"]):
        d = tmp_path / "train" / cls
        d.mkdir(parents=True)
        for i in range(3):
            arr = rng.integers(0, 255, (40, 50, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{i}.png")
    ds = pipeline.get_dataset("Imagenette", str(tmp_path), True, image_size=32)
    assert len(ds) == 6 and ds.classes == ["alpha", "beta"]
    imgs, labels = ds.gather(np.asarray([0, 3, 5]))
    assert imgs.shape == (3, 32, 32, 3) and imgs.dtype == np.uint8
    np.testing.assert_array_equal(labels, [0, 1, 1])
    # batches() goes through gather for lazy datasets
    got = list(pipeline.batches(ds, np.arange(6), 4, shuffle=False,
                                drop_remainder=False))
    assert [g[0].shape[0] for g in got] == [4, 2]
    with pytest.raises(FileNotFoundError):
        pipeline.get_dataset("Imagenette", str(tmp_path), False)
