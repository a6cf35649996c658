#!/usr/bin/env python
"""Accuracy parity of the requant-elided (fused) circuit on a TRAINED model.

Trains the flagship topology (ResNet20qat, DCT 24x16^2) on the UCI
digits dataset (real image data that needs no download), then compares clear QAT accuracy vs the
integer simulator in BOTH residual modes.  The elided circuit keeps full
accumulator resolution into the residual adds, so its accuracy should be
at parity or better with the reference-literal requant circuit — this is
the experimental evidence behind residual_mode='fused' being the default.

Usage: python tools/digits_fused_parity.py [--epochs 30]
Writes a summary line to stdout; runs on the GPU or the CPU.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from dct_cryptonets import train as tr
    from dct_cryptonets.data import CodecConfig, dct_ingest
    from dct_cryptonets.data.pipeline import load_digits_dataset
    from dct_cryptonets.fhe.compiler import lower
    from dct_cryptonets.fhe.circuit import simulate
    from dct_cryptonets.models import forward

    t0 = time.time()
    argv = ["--dataset", "digits", "--dct_status", "--model", "ResNet20qat",
            "--channels", "24", "--filter_size", "4", "--image_size_dct",
            "16", "--bit_width", "4", "--batch_size", "32", "--lr", "1e-3",
            "--stop_epoch", str(args.epochs), "--train_aug",
            "--checkpoint_dir", "/tmp/digits_fused_parity"]
    tr.main(argv)
    print(f"# training took {time.time()-t0:.0f}s")

    ck = tr.load_ckpt("/tmp/digits_fused_parity/best.tar")
    params, state = ck["state"]
    from dct_cryptonets.models import build_spec
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16,
                      num_classes=10, bit_width=4)

    cfg = CodecConfig(channels=24, filter_size=4, image_size_dct=16)
    test = load_digits_dataset(train=False, image_size=32)
    trainset = load_digits_dataset(train=True, image_size=32)
    x_te = np.asarray(dct_ingest(jnp.asarray(test.images), cfg))
    x_cal = np.asarray(dct_ingest(jnp.asarray(trainset.images[:64]), cfg))
    clf_w = np.asarray(params["classifier"]["w"])
    clf_b = np.asarray(params["classifier"]["b"])

    def acc(logits):
        return float((np.argmax(logits, -1) == test.labels).mean() * 100)

    _, logits_clear, _ = forward(params, state, jnp.asarray(x_te), spec,
                                 train=False)
    a_clear = acc(np.asarray(logits_clear))
    out = {"clear_qat": a_clear}
    for mode in ("requant", "fused"):
        circ = lower(params, state, spec, rounding_threshold_bits=6,
                     calib_data=x_cal, residual_mode=mode)
        feats = np.asarray(simulate(circ, jnp.asarray(x_te)))
        a = acc(feats @ clf_w + clf_b)
        out[mode] = a
        out[f"{mode}_pbs"] = circ.num_pbs
        out[f"{mode}_maxbits"] = circ.max_bit_width()
    print("PARITY:", out)


if __name__ == "__main__":
    main()
