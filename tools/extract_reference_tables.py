#!/usr/bin/env python
"""Extract static data tables from the reference implementation into JSON.

The reference (zhiyongggggg/dct-cryptonets) hard-codes two kinds of pure data:
  * low-frequency DCT channel-subset index tables
    (reference: dct-cryptonets/data/cvtransforms.py:1600-1912)
  * per-DCT-channel normalization statistics
    (reference: dct-cryptonets/data/__init__.py)

These are *data*, not code: training/eval parity requires the identical channel
selections and normalization constants.  We extract them with an AST walk (no
import of the reference, no code copied) and store them as JSON under
dct_cryptonets/data/tables/.  Re-run this script to regenerate.
"""
import ast
import json
import os
import sys

REF = "/root/reference/dct-cryptonets/data"
OUT = os.path.join(os.path.dirname(__file__), "..", "dct_cryptonets", "data", "tables")

WANT_CVT = [
    "subset_channel_index",
    "subset_channel_index_square",
    "subset_channel_index_learned",
    "subset_channel_index_triangle",
    "subset_channel_index_filtersize_4",
]
WANT_STATS = [
    "train_upscaled_static_mean",
    "train_upscaled_static_std",
    "train_y_mean_resized", "train_y_std_resized",
    "train_cb_mean_resized", "train_cb_std_resized",
    "train_cr_mean_resized", "train_cr_std_resized",
]


def extract_assigns(path, names):
    tree = ast.parse(open(path).read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id in names:
                try:
                    out[t.id] = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    pass
    return out


def main():
    os.makedirs(OUT, exist_ok=True)
    cvt = extract_assigns(os.path.join(REF, "cvtransforms.py"), set(WANT_CVT))
    stats = extract_assigns(os.path.join(REF, "__init__.py"), set(WANT_STATS))
    missing = [n for n in WANT_CVT if n not in cvt]
    # stats file may define fewer; only the active pair is mandatory
    req_stats = ["train_upscaled_static_mean", "train_upscaled_static_std"]
    missing += [n for n in req_stats if n not in stats]
    if missing:
        print(f"MISSING: {missing}", file=sys.stderr)
        sys.exit(1)
    with open(os.path.join(OUT, "subset_channels.json"), "w") as f:
        json.dump(cvt, f)
    with open(os.path.join(OUT, "dct_stats.json"), "w") as f:
        json.dump(stats, f)
    for k, v in cvt.items():
        print(k, "budgets:", sorted(v.keys()))
    for k, v in stats.items():
        print(k, "len:", len(v))


if __name__ == "__main__":
    main()
