"""Datasets and batching.

The reference feeds torch DataLoaders whose workers run the DCT codec per
sample (datamgr.py:229-279).  Here datasets are host-side uint8 image
arrays; batches are assembled with numpy and the codec runs *on device* as
part of the (jitted) train/eval step.

Datasets:
  * ``cifar10``    — python pickle batches (the reference's ``cifardataset/``
                     layout, train.py:267-269); falls back with a clear error
                     if the blobs are absent.
  * ``synthetic``  — deterministic random images + labels, for smoke tests,
                     benchmarks, and environments without datasets.
  * ``json``       — SimpleDataset-style JSON manifest {image_names,
                     image_labels} (reference data/dataset.py:11-34);
                     images loaded with PIL.

Split semantics copy the reference: sklearn ``train_test_split`` with
``random_state=42`` for train/val (train.py:272) and seeded test subsets
for the reliability sweep (homomorphic_eval.py:145-150, 395), reproduced
index-for-index in numpy.
"""
import json
import math
import os
import pickle

import numpy as np


class ArrayDataset:
    """images: (N, H, W, 3) uint8 RGB; labels: (N,) int."""

    def __init__(self, images, labels, classes=None):
        self.images = images
        self.labels = labels
        self.classes = classes or [str(i) for i in range(int(labels.max()) + 1)]

    def __len__(self):
        return len(self.images)

    def gather(self, idx):
        """(images, labels) for an index array (in-memory fancy index)."""
        return self.images[idx], self.labels[idx]


class FolderDataset:
    """Lazy ImageFolder (class-subdirectory) dataset.

    The ImageNet-scale reference configs can't hold the decoded train set
    in host RAM, so images decode lazily per batch (the role the torch
    DataLoader workers play in the reference, datamgr.py:229-279 — here
    decode is host-side and the DCT codec still runs on device).
    """

    def __init__(self, root: str, image_size: int = 224):
        self.image_size = image_size
        self.classes = sorted(d for d in os.listdir(root)
                              if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise FileNotFoundError(f"no class subdirectories under {root}")
        self.paths, labels = [], []
        for ci, c in enumerate(self.classes):
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.paths.append(os.path.join(cdir, f))
                    labels.append(ci)
        self.labels = np.asarray(labels, np.int32)

    def __len__(self):
        return len(self.paths)

    def _load(self, path):
        from PIL import Image
        img = Image.open(path).convert("RGB")
        s = self.image_size
        # reference eval geometry: resize shorter side to 1.15*s then
        # center-crop s (datamgr.py:193-220); the on-device train path
        # re-crops randomly from this slightly-larger frame
        w, h = img.size
        scale = (1.15 * s) / min(w, h)
        img = img.resize((max(s, round(w * scale)), max(s, round(h * scale))),
                         Image.BILINEAR)
        w, h = img.size
        l, t = (w - s) // 2, (h - s) // 2
        return np.asarray(img.crop((l, t, l + s, t + s)), np.uint8)

    def gather(self, idx):
        imgs = np.stack([self._load(self.paths[i]) for i in np.asarray(idx)])
        return imgs, self.labels[np.asarray(idx)]


def load_digits_dataset(train: bool = True, image_size: int = 32
                        ) -> ArrayDataset:
    """The UCI handwritten digits (1797 real 8x8 images, the copy scikit-learn
    ships as ``load_digits``; ``tables/digits.csv.gz``: 64 pixel columns in
    0..16 then the label) upscaled to ``image_size`` RGB — real image data
    that needs no download, used for end-to-end real-data accuracy runs
    (train -> FHE parity).
    """
    from scipy.ndimage import zoom
    d = np.loadtxt(os.path.join(os.path.dirname(__file__), "tables",
                                "digits.csv.gz"), delimiter=",")
    x8 = (d[:, :-1].reshape(-1, 8, 8) / 16.0 * 255.0)   # (N, 8, 8)
    z = image_size / 8
    x = np.stack([zoom(im, (z, z), order=1) for im in x8])
    x = np.clip(x, 0, 255).astype(np.uint8)[..., None].repeat(3, axis=-1)
    y = d[:, -1].astype(np.int32)
    tr_idx, te_idx = train_val_split(len(y), 0.2)
    idx = tr_idx if train else te_idx
    return ArrayDataset(np.ascontiguousarray(x[idx]), y[idx],
                        [str(i) for i in range(10)])


def load_cifar10(root: str, train: bool = True) -> ArrayDataset:
    d = os.path.join(root, "cifar-10-batches-py")
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for f in files:
        path = os.path.join(d, f)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"CIFAR-10 batch {path} not found — pass --dataset synthetic "
                "or provide the python-pickle batches")
        with open(path, "rb") as fh:
            batch = pickle.load(fh, encoding="bytes")
        xs.append(batch[b"data"])
        ys.append(batch[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.concatenate([np.asarray(b) for b in ys])
    classes = ["airplane", "automobile", "bird", "cat", "deer",
               "dog", "frog", "horse", "ship", "truck"]
    return ArrayDataset(np.ascontiguousarray(x), y.astype(np.int32), classes)


def load_synthetic(num: int = 2048, image_size: int = 32,
                   num_classes: int = 10, seed: int = 0) -> ArrayDataset:
    """Deterministic class-structured random images: each class has a color
    + frequency signature so models can actually fit them."""
    from scipy.ndimage import zoom
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num).astype(np.int32)
    # smooth low-frequency class signatures (sharp tile edges would produce
    # unnatural AC coefficients far outside the reference's normalization
    # statistics, which are computed on natural images)
    base = rng.integers(64, 192, (num_classes, 4, 4, 3)).astype(np.float64)
    z = image_size / 4
    templates = np.stack([zoom(b, (z, z, 1), order=1) for b in base])
    x = np.empty((num, image_size, image_size, 3), np.uint8)
    for i in range(num):
        noise = zoom(rng.normal(0, 20, (8, 8, 3)), (image_size / 8,) * 2 + (1,),
                     order=1)
        x[i] = np.clip(templates[y[i]] + noise, 0, 255).astype(np.uint8)
    return ArrayDataset(x, y)


class ManifestDataset:
    """Lazy SimpleDataset-style JSON manifest (reference data/dataset.py:11-34).

    Construction reads only the manifest metadata (O(entries), no image
    decode), so miniImageNet-scale manifests (60k images) cost megabytes,
    not the decoded dataset; images decode per batch in :meth:`gather`,
    the same pattern as :class:`FolderDataset`.
    """

    def __init__(self, path: str, image_size: int | None = None):
        with open(path) as f:
            meta = json.load(f)
        self.paths = meta["image_names"]
        self.labels = np.asarray(meta["image_labels"], np.int32)
        self.classes = meta.get("label_names") or [
            str(i) for i in range(int(self.labels.max()) + 1)]
        self.image_size = image_size

    def __len__(self):
        return len(self.paths)

    def _load(self, path):
        from PIL import Image
        img = Image.open(path).convert("RGB")
        if self.image_size is not None and img.size != (self.image_size,) * 2:
            # the reference's SimpleDataset does no resize (dataset.py:19-31;
            # sizing happens in the transform/codec) — this resize exists
            # only to standardize the stacked batch shape ahead of the
            # on-device cv2-exact Resize/CenterCrop in the codec, so use an
            # explicit smooth filter rather than PIL's version-dependent
            # default (aliasing here would leak through the bit-matched
            # codec path)
            img = img.resize((self.image_size, self.image_size),
                             Image.BILINEAR)
        return np.asarray(img, np.uint8)

    def gather(self, idx):
        imgs = np.stack([self._load(self.paths[i]) for i in np.asarray(idx)])
        return imgs, self.labels[np.asarray(idx)]


def load_json_manifest(path: str, image_size: int | None = None
                       ) -> ManifestDataset:
    """Open a JSON manifest lazily (images decode per batch, not here)."""
    return ManifestDataset(path, image_size)


def train_val_split(n: int, test_size, random_state: int = 42):
    """(train, test) indices of sklearn's ``train_test_split(np.arange(n),
    test_size=..., random_state=...)`` (reference train.py:272): one
    ``RandomState`` permutation, the first ``ceil(test_size * n)`` items
    (or ``test_size`` items for an int) are the test part."""
    perm = np.random.RandomState(random_state).permutation(n)
    n_test = (math.ceil(test_size * n) if isinstance(test_size, float)
              else int(test_size))
    return perm[n_test:], perm[:n_test]


def batches(ds, idx, batch_size: int, *, shuffle: bool,
            seed: int = 0, drop_remainder: bool = True):
    """Yield (images, labels) numpy batches over the given indices."""
    idx = np.asarray(idx)
    if shuffle:
        idx = idx[np.random.default_rng(seed).permutation(len(idx))]
    end = len(idx) - (len(idx) % batch_size) if drop_remainder else len(idx)
    gather = getattr(ds, "gather", None)
    for s in range(0, end, batch_size):
        take = idx[s:s + batch_size]
        if gather is not None:
            yield gather(take)
        else:
            yield ds.images[take], ds.labels[take]


def get_dataset(name: str, path: str | None, train: bool, *,
                image_size: int = 32, num_classes: int = 10,
                synthetic_size: int = 2048):
    if name == "cifar10":
        return load_cifar10(path or "./cifardataset", train)
    if name == "synthetic":
        return load_synthetic(synthetic_size if train else synthetic_size // 4,
                              image_size, num_classes,
                              seed=0 if train else 1)
    if name == "digits":
        return load_digits_dataset(train, image_size)
    if name in ("ImageNet", "Imagenette", "miniImagenet"):
        # ImageFolder layouts from scripts/install_datasets.sh; the usual
        # split subdirectory names per dataset (reference train.py:266-314)
        root = path or "."
        for split_dir in (("train",) if train else ("val", "validation",
                                                    "test")):
            cand = os.path.join(root, split_dir)
            if os.path.isdir(cand):
                return FolderDataset(cand, image_size)
        raise FileNotFoundError(
            f"no {'train' if train else 'val/test'} split under {root} — "
            "run scripts/install_datasets.sh or pass --dataset_path")
    if name.endswith(".json"):
        return load_json_manifest(name)
    raise ValueError(f"unknown dataset {name!r}")
