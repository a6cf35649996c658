"""Homomorphic evaluation entry point.

Mirrors the reference ``homomorphic_eval.py`` flow (reference
homomorphic_eval.py:89-443): load checkpoint -> calibrate -> compile the
*trunk* to an FHE circuit (classifier stays clear) -> feasibility check
(max bit-width <= 16) -> keygen -> clear eval -> simulate eval ->
execute eval -> reliability sweep over seeded test subsets.

Run (simulate, synthetic smoke):
  python -m dct_cryptonets.homomorphic_eval --dataset synthetic \
      --dct_status --model ResNet20qat --channels 24 --filter_size 4 \
      --image_size_dct 16 --test_subset 16 --fhe_mode simulate
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from .config import parse_args
from .data import pipeline
from .data.codec import CodecConfig, dct_ingest, rgb_ingest
from .fhe.runtime import compile_ptq_model, compile_qat_model
from .models import (build_spec, calibrate_scales, forward, init_model,
                     model_summary)
from .utils import AverageMeter, enable_compile_cache, topk_accuracy


def make_ingest(codec_cfg, image_size: int = 32, dataset: str = "cifar10"):
    """Eval-path ingest closure: DCT codec when ``codec_cfg`` is given,
    else the reference's RGB aug=False transform (Resize 1.15x +
    CenterCrop + Normalize with per-dataset stats, datamgr.py:82-90)."""
    def _in(images):
        if codec_cfg is None:
            return rgb_ingest(jnp.asarray(images), image_size, dataset)
        return dct_ingest(jnp.asarray(images), codec_cfg)
    return _in


def test_unencrypted(params, state, spec, ingest, ds, idx, batch):
    top1, top5 = AverageMeter(), AverageMeter()
    for images, labels in pipeline.batches(ds, idx, batch, shuffle=False,
                                           drop_remainder=False):
        x = ingest(images)
        _, logits, _ = forward(params, state, x, spec, train=False)
        p1, p5 = topk_accuracy(np.asarray(logits), labels)
        top1.update(p1, len(labels))
        top5.update(p5, len(labels))
    return top1, top5


def test_encrypted(module, clf_w, clf_b, ingest, ds, idx, batch, fhe_mode,
                   drop_limbs=0, mesh=None, resume=None, check_ref=False):
    """Encrypted-trunk + clear-classifier eval (reference
    homomorphic_eval.py:60-86).

    ``mesh``: optional device mesh — the ciphertext batch shards across it
    (keys must already be placed via ``module.shard_over(mesh)``).
    ``resume``: optional :class:`SweepState` — per-batch results persist to
    disk so a multi-hour execute sweep survives interruption (SURVEY §5
    failure recovery; absent in the reference, which restarts from zero).
    ``check_ref``: realized-slip audit (``--slip_audit``) — per-TLU
    decrypt-compare against the simulator, results in ``module.stats``.
    Returns the top-1/top-5 meters and the predicted classes of the batches
    evaluated in this call.
    """
    top1, top5 = AverageMeter(), AverageMeter()
    preds = []
    for bi, (images, labels) in enumerate(pipeline.batches(
            ds, idx, batch, shuffle=False, drop_remainder=False)):
        if resume is not None and resume.has(bi):
            p1, p5, n = resume.get(bi)
            top1.update(p1, n)
            top5.update(p5, n)
            continue
        x = np.asarray(ingest(images))
        feats = module.forward(x, fhe=fhe_mode, drop_limbs=drop_limbs,
                               mesh=mesh, check_ref=check_ref)
        logits = feats @ clf_w + clf_b
        preds.extend(np.argmax(logits, axis=1).tolist())
        p1, p5 = topk_accuracy(logits, labels)
        top1.update(p1, len(labels))
        top5.update(p5, len(labels))
        if resume is not None:
            resume.record(bi, p1, p5, len(labels))
    return top1, top5, preds


class SweepState:
    """Checkpoint/resume for long encrypted-execute sweeps.

    Persists per-batch accuracy records as JSONL keyed by a config tag, so
    a killed multi-image run (~minutes/image encrypted) resumes where it
    stopped instead of from zero.  The tag covers everything that changes
    the numbers (checkpoint, circuit knobs, subset seed); a mismatched tag
    starts fresh."""

    def __init__(self, path: str, tag: str):
        self.path = path
        self.tag = tag
        self.done: dict = {}
        if os.path.exists(path):
            import json
            with open(path) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("tag") == tag:
                        self.done[rec["batch"]] = (rec["top1"], rec["top5"],
                                                   rec["n"])

    def has(self, bi: int) -> bool:
        return bi in self.done

    def get(self, bi: int):
        return self.done[bi]

    def record(self, bi: int, p1: float, p5: float, n: int):
        import json
        self.done[bi] = (p1, p5, n)
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"tag": self.tag, "batch": bi, "top1": p1,
                                 "top5": p5, "n": n}) + "\n")
            fh.flush()


def main(argv=None):
    cfg = parse_args("homomorphic_eval", argv)
    enable_compile_cache()
    if getattr(cfg, "profile_dir", None):
        with jax.profiler.trace(cfg.profile_dir):
            return main_impl(cfg)
    return main_impl(cfg)


def main_impl(cfg):
    """Run the evaluation for parsed flags ``cfg``; returns a dict of the
    accuracies it printed (``clear_val``, ``clear_test``, ``enc_val`` in
    simulate mode, ``enc_test``: (top1, top5) pairs), the test images'
    predicted classes (``enc_test_pred``) with what produced them
    (``testset``, ``test_idx``, ``ingest``, ``classifier``), the compiled
    ``module`` (its ``stats`` hold execute/PBS/keygen times and the slip
    audit), and the reliability sweep lists when that ran."""
    results = {}
    img = cfg.image_size_dct if cfg.dct_status else cfg.image_size
    in_ch = cfg.channels if cfg.dct_status else 3
    spec = build_spec(cfg.model, in_channels=in_ch, img_size=img,
                      num_classes=cfg.num_classes, bit_width=cfg.bit_width)
    codec_cfg = CodecConfig(cfg.channels, cfg.filter_size, cfg.image_size_dct,
                            cfg.dct_pattern) if cfg.dct_status else None
    ingest = make_ingest(codec_cfg, cfg.image_size, cfg.dataset)

    pix = codec_cfg.pixel_size if codec_cfg else cfg.image_size
    trainset = pipeline.get_dataset(cfg.dataset, cfg.dataset_path, True,
                                    image_size=pix,
                                    num_classes=cfg.num_classes)
    testset = pipeline.get_dataset(cfg.dataset, cfg.dataset_path, False,
                                   image_size=pix,
                                   num_classes=cfg.num_classes)

    # seeded subset selection (reference homomorphic_eval.py:145-150)
    _, val_idx = pipeline.train_val_split(len(trainset), cfg.test_subset)
    _, test_idx = pipeline.train_val_split(
        len(testset), min(cfg.test_subset, len(testset) - 1))

    # model + checkpoint
    params, state = init_model(jax.random.key(0), spec)
    if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        from .train import load_ckpt
        ck = load_ckpt(cfg.checkpoint_path)
        params, state = ck["state"]
        print(f"Loaded checkpoint {cfg.checkpoint_path} "
              f"({ck['prec1']:.3f}% Top-1 @ epoch {ck['epoch']})")
    else:
        print("WARNING: No checkpoint loaded. Using random weights "
              "(for testing only)")
        calib_imgs = trainset.gather(
            np.arange(min(cfg.calib_batch_size, len(trainset))))[0]
        params = calibrate_scales(params, state,
                                  ingest(calib_imgs), spec)
        _, _, state = forward(params, state,
                              ingest(calib_imgs), spec, train=True)

    # compile trunk -> FHE circuit (classifier stays clear); the first
    # calib batch drives accumulator-range calibration
    # (reference homomorphic_eval.py:258-261)
    # QAT vs PTQ from the model name, like the reference
    # (homomorphic_eval.py:95-98: 'qat' in name -> brevitas path, else
    # post-training quantization via compile_torch_model)
    # per-layer topology summary (reference train.py:335-347, torchinfo)
    print("\n" + model_summary(spec, params))

    quantization_type = "QAT" if spec.quantized else "PTQ"
    print(f"\nCompiling FHE Model ({quantization_type})...")
    calib_imgs = trainset.gather(
        np.arange(min(cfg.calib_batch_size, len(trainset))))[0]
    calib_x = np.asarray(ingest(calib_imgs))
    t = time.time()
    if quantization_type == "QAT":
        module = compile_qat_model(
            params, state, spec, n_bits=cfg.n_bits,
            rounding_threshold_bits={
                "n_bits": cfg.rounding_threshold_bits,
                "method": getattr(cfg, "rounding_method", "exact")},
            calib_data=calib_x,
            pbs_batch=cfg.pbs_batch,
            drop_policy=getattr(cfg, "drop_policy", "none"),
            p_error=cfg.p_error,
            range_margin=getattr(cfg, "range_margin", 1.0),
            residual_mode=getattr(cfg, "residual_mode", "fused"))
    else:
        module = compile_ptq_model(
            params, state, spec, calib_x, n_bits=cfg.n_bits,
            rounding_threshold_bits=cfg.rounding_threshold_bits,
            pbs_batch=cfg.pbs_batch)
    print(f"Time for FHE compilation {time.time()-t:.2f}")

    bitwidth = module.maximum_integer_bit_width()
    print(f"Max bit-width: {bitwidth} bits" +
          (" -> it works in FHE!!" if bitwidth <= 16
           else " too high for FHE computation"))
    print(f"PBS per image: {module.circuit.num_pbs}")

    if getattr(cfg, "dump_circuit", None):
        # the reference dumps its MLIR circuit to mlir.txt
        # (homomorphic_eval.py:309-311); ours is the Circuit listing plus
        # the noise-audit summary when the audit policy is active
        text = module.circuit.dump()
        if getattr(cfg, "drop_policy", "none") == "audit":
            text += "\n\n" + module.run_audit().summary()
        with open(cfg.dump_circuit, "w") as fh:
            fh.write(text + "\n")
        print(f"Circuit dumped to {cfg.dump_circuit}")

    mesh = None
    if cfg.fhe_mode == "execute":
        t = time.time()
        module.keygen()
        print(f"Keygen time: {time.time()-t:.2f}s")
        if getattr(cfg, "mesh", None):
            from .parallel import data_mesh
            mesh = data_mesh(int(cfg.mesh))
            module.shard_over(mesh)
            print(f"Sharded encrypted eval over {mesh.devices.shape[0]} "
                  f"device(s) (keys replicated, ciphertext batch sharded)")

    clf_w = np.asarray(params["classifier"]["w"])
    clf_b = np.asarray(params["classifier"]["b"])

    # clear sanity eval
    print(f"\nRunning UNENCRYPTED model on a subset of {cfg.test_subset} images...")
    v1, v5 = test_unencrypted(params, state, spec, ingest, trainset,
                              val_idx, cfg.calib_batch_size)
    t1, t5 = test_unencrypted(params, state, spec, ingest, testset,
                              test_idx, cfg.calib_batch_size)
    print(f"[Validation] Top-1 Acc: {v1.avg:.3f}% | Top-5 Acc: {v5.avg:.3f}%")
    print(f"[Test] Top-1 Acc: {t1.avg:.3f}% | Top-5 Acc: {t5.avg:.3f}%")
    results.update(module=module, clear_val=(v1.avg, v5.avg),
                   clear_test=(t1.avg, t5.avg))

    # encrypted (or simulated) eval
    if cfg.fhe_mode == "simulate":
        t = time.time()
        print(f"\nRunning ENCRYPTED validation inference in SIMULATE mode...")
        e1, e5, _ = test_encrypted(module, clf_w, clf_b, ingest, trainset,
                                   val_idx, cfg.calib_batch_size, "simulate")
        dt = (time.time() - t) / max(len(val_idx), 1)
        print(f"[Validation] Top-1 Acc: {e1.avg:.3f}% | Top-5 Acc: "
              f"{e5.avg:.3f}% | Time per inference: {dt:.3f}")
        results["enc_val"] = (e1.avg, e5.avg)

    resume = None
    if cfg.fhe_mode == "execute" and getattr(cfg, "sweep_state", None):
        # the tag must cover EVERYTHING that changes the compiled circuit or
        # the eval numerics — a re-run with any different value must start
        # fresh rather than silently mix per-batch records from two configs
        p = module.params
        tag = (f"{cfg.model}|{cfg.checkpoint_path}|{cfg.dataset}|"
               f"r{cfg.rounding_threshold_bits}|n{cfg.n_bits}|"
               f"{getattr(cfg, 'rounding_method', 'exact')}|"
               f"{getattr(cfg, 'residual_mode', 'fused')}|"
               f"{getattr(cfg, 'drop_policy', 'none')}|b{cfg.test_batch_size}"
               f"|s{cfg.test_subset}|pe{cfg.p_error}"
               f"|m{getattr(cfg, 'range_margin', 1.0)}|d{cfg.drop_limbs}"
               f"|P{p.lwe_dim}.{p.glwe_dim}.{p.poly_size}")
        resume = SweepState(cfg.sweep_state, tag)
        if resume.done:
            print(f"Resuming execute sweep: {len(resume.done)} batch(es) "
                  f"already recorded in {cfg.sweep_state}")

    t = time.time()
    print(f"\nRunning ENCRYPTED test inference in {cfg.fhe_mode.upper()} mode "
          f"on a subset of {len(test_idx)} images...")
    e1, e5, preds = test_encrypted(
        module, clf_w, clf_b, ingest, testset, test_idx, cfg.test_batch_size,
        cfg.fhe_mode, cfg.drop_limbs, mesh=mesh, resume=resume,
        check_ref=getattr(cfg, "slip_audit", False))
    dt = (time.time() - t) / max(len(test_idx), 1)
    print(f"[Test] Top-1 Acc: {e1.avg:.3f}% | Top-5 Acc: {e5.avg:.3f}% | "
          f"Time per inference in FHE: {dt:.2f}")
    results.update(enc_test=(e1.avg, e5.avg), enc_test_pred=preds,
                   test_idx=test_idx, testset=testset, ingest=ingest,
                   classifier=(clf_w, clf_b))
    if cfg.fhe_mode == "execute" and module.stats.get("pbs_per_sec"):
        s = module.stats
        print(f"[Stats] execute {s['execute_time']:.1f}s | levelled "
              f"{s['levelled_time']:.1f}s | PBS "
              f"{s['pbs_time']:.1f}s ({s['pbs_per_sec']:.1f} PBS/s, "
              f"{s.get('aux_pbs_executed', 0)} extraction bootstraps) | "
              f"keygen {s.get('keygen_time', 0):.1f}s")
        if "tlu_slips" in s:
            print(f"[Slip audit] {s['tlu_slips']} realized TLU slips / "
                  f"{s['tlu_sites']} TLU sites (audited per-PBS p_error "
                  f"<= {module.p_error}); audit overhead "
                  f"{s.get('audit_time', 0):.1f}s (excluded from execute)")

    # reliability sweep (reference homomorphic_eval.py:366-440)
    if cfg.reliability_test and cfg.fhe_mode == "simulate":
        print("\n============ Encrypted Reliability Analysis ============")
        top1_plain, top5_plain, top1_enc, top5_enc = [], [], [], []
        for rstate in range(27, 29):
            _, sub_idx = pipeline.train_val_split(
                len(testset), min(cfg.test_subset, len(testset) - 1),
                random_state=rstate)
            p1, p5 = test_unencrypted(params, state, spec, ingest,
                                      testset, sub_idx, cfg.calib_batch_size)
            e1, e5, _ = test_encrypted(module, clf_w, clf_b, ingest,
                                       testset, sub_idx, cfg.calib_batch_size,
                                       "simulate")
            top1_plain.append(round(p1.avg, 3))
            top5_plain.append(round(p5.avg, 3))
            top1_enc.append(round(e1.avg, 3))
            top5_enc.append(round(e5.avg, 3))
        print(f"Unencrypted top1 acc: {top1_plain}")
        print(f"Unencrypted top5 acc: {top5_plain}")
        print(f"Encrypted top1 acc: {top1_enc}")
        print(f"Encrypted top5 acc: {top5_enc}")
        results["reliability"] = dict(top1_plain=top1_plain,
                                      top5_plain=top5_plain,
                                      top1_enc=top1_enc, top5_enc=top5_enc)
    print("Done")
    return results


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted")
        sys.exit(130)
