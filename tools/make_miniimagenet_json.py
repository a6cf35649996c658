#!/usr/bin/env python
"""Build miniImageNet JSON manifests from train/val/test CSV splits.

Equivalent of the reference ``data/make_miniImageNet_json.py`` (113 lines):
reads Ravi/Larochelle-style CSVs (``filename,label``) and emits
``{base,val,novel}.json`` manifests with ``label_names`` / ``image_names`` /
``image_labels`` keys consumable by
``dct_cryptonets.data.pipeline.load_json_manifest``.

Usage:
  python tools/make_miniimagenet_json.py --csv_dir <dir with train/val/test.csv> \
      --image_dir <dir with class subdirs or flat jpgs> --out_dir <dataset dir>
"""
import argparse
import csv
import json
import os


SPLIT_NAMES = {"train": "base", "val": "val", "test": "novel"}


def build_manifest(csv_path: str, image_dir: str) -> dict:
    label_names: list[str] = []
    image_names: list[str] = []
    image_labels: list[int] = []
    with open(csv_path) as f:
        reader = csv.reader(f)
        header = next(reader)
        assert header[0].lower().startswith("file"), header
        for fname, label in reader:
            if label not in label_names:
                label_names.append(label)
            cls_dir = os.path.join(image_dir, label)
            path = (os.path.join(cls_dir, fname)
                    if os.path.isdir(cls_dir) else os.path.join(image_dir, fname))
            image_names.append(path)
            image_labels.append(label_names.index(label))
    return {"label_names": label_names, "image_names": image_names,
            "image_labels": image_labels}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv_dir", required=True)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    for split, out_name in SPLIT_NAMES.items():
        csv_path = os.path.join(args.csv_dir, f"{split}.csv")
        if not os.path.exists(csv_path):
            print(f"skip {split}: {csv_path} not found")
            continue
        manifest = build_manifest(csv_path, args.image_dir)
        out = os.path.join(args.out_dir, f"{out_name}.json")
        with open(out, "w") as f:
            json.dump(manifest, f)
        print(f"{out}: {len(manifest['image_names'])} images, "
              f"{len(manifest['label_names'])} classes")


if __name__ == "__main__":
    main()
