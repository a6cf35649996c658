"""CLI driver smoke tests: train + homomorphic_eval on synthetic data."""
import numpy as np


def test_train_one_epoch(tmp_path, capsys):
    from dct_cryptonets.train import main
    main(["--dataset", "synthetic", "--dct_status", "--model", "ResNet20qat",
          "--channels", "24", "--filter_size", "4", "--image_size_dct", "16",
          "--stop_epoch", "1", "--batch_size", "64", "--test_batch_size", "50",
          "--synthetic_size", "256", "--save_path", str(tmp_path),
          "--verbose", ""])
    out = capsys.readouterr().out
    assert "Mesh: 8 device(s)" in out
    assert "Test Acc:" in out
    assert "nan" not in out.lower()
    best = list(tmp_path.rglob("best.tar"))
    assert best, "no best checkpoint written"


def test_homomorphic_eval_simulate(capsys):
    from dct_cryptonets.homomorphic_eval import main
    main(["--dataset", "synthetic", "--dct_status", "--model", "ResNet20qat",
          "--channels", "24", "--filter_size", "4", "--image_size_dct", "16",
          "--test_subset", "8", "--fhe_mode", "simulate",
          "--calib_batch_size", "16", "--reliability_test", ""])
    out = capsys.readouterr().out
    assert "Max bit-width:" in out and "it works in FHE" in out
    assert "ENCRYPTED test inference in SIMULATE mode" in out
    assert "Done" in out


def test_homomorphic_eval_ptq_simulate(capsys):
    """Non-QAT model name routes through the PTQ compile path (reference
    homomorphic_eval.py:95-98)."""
    from dct_cryptonets.homomorphic_eval import main
    main(["--dataset", "synthetic", "--dct_status", "--model", "ResNet20",
          "--channels", "24", "--filter_size", "4", "--image_size_dct", "16",
          "--test_subset", "4", "--fhe_mode", "simulate", "--n_bits", "5",
          "--calib_batch_size", "16"])
    out = capsys.readouterr().out
    assert "Compiling FHE Model (PTQ)" in out
    assert "Max bit-width:" in out and "it works in FHE" in out
    assert "Done" in out


def test_train_rgb_with_aug(tmp_path, capsys):
    """RGB (non-DCT) training path with --train_aug: RandomResizedCrop +
    jitter + hflip wired into the jitted train step (reference
    datamgr.py:69-80); eval path uses Resize 1.15x + CenterCrop."""
    from dct_cryptonets.train import main
    main(["--dataset", "synthetic", "--model", "ResNet20qat",
          "--image_size", "32", "--train_aug",
          "--stop_epoch", "1", "--batch_size", "64", "--test_batch_size",
          "50", "--synthetic_size", "256", "--save_path", str(tmp_path),
          "--verbose", ""])
    out = capsys.readouterr().out
    assert "Test Acc:" in out
    assert "nan" not in out.lower()
