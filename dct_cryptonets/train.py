"""Training entry point.

Mirrors the reference trainer's behavior (reference train.py:31-421):
config-derived checkpoint dirs, adam/adamw/sgd + step-decay schedule,
gradient clipping, per-epoch validation, periodic + best checkpointing,
early stopping, final best-model test — but accelerator-resident:

* the DCT codec runs *inside* the jitted train step on device (no worker
  processes);
* data parallelism via a jax.sharding mesh (batch sharded, params
  replicated, gradient all-reduce between devices) instead of
  nn.DataParallel;
* checkpoints carry the same payload keys ({epoch, state, prec1, prec5,
  optimizer}, reference train.py:82-89) in a pickle of numpy pytrees.

Run:  python -m dct_cryptonets.train --dataset synthetic --dct_status \
          --model ResNet20qat --channels 24 --filter_size 4 \
          --image_size_dct 16 --stop_epoch 2
"""
import functools
import os
import pickle
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .config import checkpoint_dir_for, parse_args
from .data.codec import (CodecConfig, dct_ingest, dct_ingest_train,
                         rgb_ingest, rgb_ingest_train)
from .data import pipeline
from .models import (build_spec, calibrate_scales, forward, init_model,
                     model_summary)
from .parallel import data_mesh, replicate, shard_batch
from .utils import (AverageMeter, EarlyStopper, enable_compile_cache,
                    step_decay_lr, topk_accuracy)


def make_optimizer(params_cfg, lr):
    if params_cfg.optimizer == "adam":
        opt = optax.adam(lr)
    elif params_cfg.optimizer == "adamw":
        opt = optax.adamw(lr, weight_decay=params_cfg.weight_decay)
    else:
        opt = optax.sgd(lr, momentum=params_cfg.momentum)
    chain = []
    if params_cfg.grad_clip_value is not None:
        chain.append(optax.clip(params_cfg.grad_clip_value))
    elif params_cfg.grad_clip_norm is not None:
        chain.append(optax.clip_by_global_norm(params_cfg.grad_clip_norm))
    if params_cfg.optimizer == "adam" and params_cfg.weight_decay:
        # torch Adam applies L2 via weight_decay on the gradient
        chain.append(optax.add_decayed_weights(params_cfg.weight_decay))
    chain.append(opt)
    return optax.chain(*chain)


def cross_entropy(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))


def make_steps(spec, cfg, codec_cfg, opt, dropout):
    """Build jitted train/eval steps with the codec fused in."""

    def ingest(key, images, train):
        if codec_cfg is None:
            # RGB path (reference datamgr.get_composed_transform): aug=True
            # -> RandomResizedCrop + jitter (0.1 for cifar10 RGB) + hflip;
            # aug=False -> Resize(1.15x) + CenterCrop; then Normalize
            if train and cfg.train_aug:
                return rgb_ingest_train(key, images, cfg.image_size,
                                        cfg.dataset)
            return rgb_ingest(images, cfg.image_size, cfg.dataset)
        if train and cfg.train_aug:
            return dct_ingest_train(key, images, codec_cfg)
        return dct_ingest(images, codec_cfg)

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def train_step(params, state, opt_state, key, images, labels):
        kin, kdrop = jax.random.split(key)
        x = ingest(kin, images, train=True)

        def loss_fn(p):
            feats, logits, new_state = forward(p, state, x, spec, train=True)
            if dropout:
                # forward-hook dropout on the classifier output
                # (reference train.py:396)
                logits = jnp.where(
                    jax.random.bernoulli(kdrop, 1 - dropout, logits.shape),
                    logits / (1 - dropout), 0.0)
            loss = cross_entropy(logits, labels)
            return loss, (logits, new_state)

        (loss, (logits, new_state)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, new_state, opt_state, loss, logits

    @jax.jit
    def eval_step(params, state, images, labels):
        x = ingest(None, images, train=False)
        feats, logits, _ = forward(params, state, x, spec, train=False)
        loss = cross_entropy(logits, labels)
        return loss, logits

    return train_step, eval_step


def save_ckpt(path, epoch, params, state, opt_state, prec1, prec5):
    payload = {
        "epoch": epoch,
        "state": jax.device_get((params, state)),
        "prec1": prec1,
        "prec5": prec5,
        "optimizer": jax.device_get(opt_state),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_ckpt(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def main(argv=None):
    cfg = parse_args("train", argv)
    enable_compile_cache()
    if getattr(cfg, "profile_dir", None):
        with jax.profiler.trace(cfg.profile_dir):
            return main_impl(cfg)
    return main_impl(cfg)


def main_impl(cfg):
    ckpt_dir = checkpoint_dir_for(cfg)
    os.makedirs(ckpt_dir, exist_ok=True)
    print(f"Checkpoint dir: {ckpt_dir}")

    img = cfg.image_size_dct if cfg.dct_status else cfg.image_size
    in_ch = cfg.channels if cfg.dct_status else 3
    spec = build_spec(cfg.model, in_channels=in_ch, img_size=img,
                      num_classes=cfg.num_classes, bit_width=cfg.bit_width)
    codec_cfg = CodecConfig(cfg.channels, cfg.filter_size, cfg.image_size_dct,
                            cfg.dct_pattern) if cfg.dct_status else None

    # datasets + reference split semantics (train_test_split rs=42)
    pix = codec_cfg.pixel_size if codec_cfg else cfg.image_size
    trainset = pipeline.get_dataset(
        cfg.dataset if cfg.dataset != "cifar10" else "cifar10",
        cfg.dataset_path, True, image_size=pix, num_classes=cfg.num_classes,
        synthetic_size=cfg.synthetic_size)
    testset = pipeline.get_dataset(
        cfg.dataset if cfg.dataset != "cifar10" else "cifar10",
        cfg.dataset_path, False, image_size=pix, num_classes=cfg.num_classes,
        synthetic_size=cfg.synthetic_size)
    train_idx, val_idx = pipeline.train_val_split(len(trainset), 0.1)

    mesh = data_mesh(int(cfg.mesh) if cfg.mesh else None)
    ndev = mesh.devices.shape[0]
    print(f"Mesh: {ndev} device(s)")
    assert cfg.batch_size % ndev == 0, \
        f"--batch_size {cfg.batch_size} must divide the {ndev}-device mesh"

    params, state = init_model(jax.random.key(0), spec)
    # per-layer topology summary (reference train.py:335-347, torchinfo)
    print(model_summary(spec, params))
    if spec.quantized:
        # runtime-stats activation-scale calibration on one batch
        imgs0, _ = trainset.gather(train_idx[:64])
        x0 = (dct_ingest(jnp.asarray(imgs0), codec_cfg) if codec_cfg
              else rgb_ingest(jnp.asarray(imgs0), cfg.image_size,
                              cfg.dataset))
        params = calibrate_scales(params, state, x0, spec)

    n_params = sum(int(np.prod(p.shape))
                   for p in jax.tree_util.tree_leaves(params))
    print(f"Number Parameters: {n_params}")

    opt = make_optimizer(cfg, cfg.lr)
    opt_state = opt.init(params)
    train_step, eval_step = make_steps(spec, cfg, codec_cfg, opt, cfg.dropout)
    stopper = EarlyStopper(patience=10, threshold=0.03)

    start_epoch = cfg.start_epoch
    best_val = 0.0
    if cfg.resume:
        ck = load_ckpt(cfg.resume)
        params, state = ck["state"]
        opt_state = ck["optimizer"]
        start_epoch = ck["epoch"]
        best_val = ck["prec1"]
        print(f"Resumed {cfg.resume} ({best_val:.3f}% @ epoch {ck['epoch']})")

    params = replicate(mesh, params)
    state = replicate(mesh, state)
    key = jax.random.key(1234)

    if not cfg.dct_status:
        # example-image grid (reference train.py:394-395 plots only for
        # the RGB path)
        from .viz import plot_examples
        plot_examples(ckpt_dir, trainset.gather(train_idx[:64])[0],
                      trainset.labels[train_idx[:64]], trainset.classes)

    log_path = os.path.join(ckpt_dir, "train_log.jsonl")

    for epoch in range(start_epoch, cfg.stop_epoch):
        lr = step_decay_lr(cfg.lr, cfg.schedule, cfg.gamma, epoch)
        if cfg.schedule and epoch + 1 in cfg.schedule:
            # reference resets optimizer LR on schedule (utils.py:127-133);
            # we rebuild the optax transform with the decayed LR
            opt = make_optimizer(cfg, lr)
            train_step, eval_step = make_steps(spec, cfg, codec_cfg, opt,
                                               cfg.dropout)
        print(f"\nEpoch: [{epoch + 1} | {cfg.stop_epoch}] LR: {lr}")

        t = time.time()
        tl, t1, t5 = AverageMeter(), AverageMeter(), AverageMeter()
        nb = 0
        for images, labels in pipeline.batches(
                trainset, train_idx, cfg.batch_size, shuffle=True, seed=epoch):
            key, sk = jax.random.split(key)
            images, labels = shard_batch(mesh, (images, labels.astype(np.int32)))
            params, state, opt_state, loss, logits = train_step(
                params, state, opt_state, sk, images, labels)
            p1, p5 = topk_accuracy(logits, labels)
            tl.update(float(loss), len(labels))
            t1.update(p1, len(labels))
            t5.update(p5, len(labels))
            nb += 1
            if cfg.verbose and nb % 50 == 0:
                print(f"[{nb}] Avg. Train Loss: {tl.avg:.3f} | "
                      f"Top-1 Acc: {t1.avg:.3f}% | Top-5 Acc: {t5.avg:.3f}%")
        print(f"Time for training epoch {epoch}: {(time.time()-t)/60:.2f} min")

        if (epoch % cfg.save_freq == 0) or (epoch == cfg.stop_epoch - 1):
            save_ckpt(os.path.join(ckpt_dir, f"{epoch}.tar"), epoch, params,
                      state, opt_state, t1.avg, t5.avg)

        # validation (unsharded: batches may not divide the mesh)
        vl, v1, v5 = AverageMeter(), AverageMeter(), AverageMeter()
        for images, labels in pipeline.batches(
                trainset, val_idx, cfg.test_batch_size, shuffle=False,
                drop_remainder=False):
            images, labels = jnp.asarray(images), jnp.asarray(labels.astype(np.int32))
            loss, logits = eval_step(params, state, images, labels)
            p1, p5 = topk_accuracy(logits, labels)
            vl.update(float(loss), len(labels))
            v1.update(p1, len(labels))
            v5.update(p5, len(labels))
        print(f"Avg. Val Loss: {vl.avg:.3f} | Top-1 Acc: {v1.avg:.3f}% | "
              f"Top-5 Acc: {v5.avg:.3f}%")

        if v1.avg > best_val:
            best_val = v1.avg
            save_ckpt(os.path.join(ckpt_dir, "best.tar"), epoch, params,
                      state, opt_state, v1.avg, v5.avg)

        # structured JSONL metrics (auxiliary observability; the reference
        # only prints to stdout under nohup)
        import json as _json
        with open(log_path, "a") as lf:
            lf.write(_json.dumps({
                "epoch": epoch, "lr": lr,
                "train_loss": round(tl.avg, 5), "train_top1": round(t1.avg, 3),
                "val_loss": round(vl.avg, 5), "val_top1": round(v1.avg, 3),
                "val_top5": round(v5.avg, 3),
            }) + "\n")

        if stopper(vl.avg):
            print(f"Early stopping at epoch: {epoch}")
            break

    # final test with best model
    best = os.path.join(ckpt_dir, "best.tar")
    if os.path.exists(best):
        ck = load_ckpt(best)
        params, state = ck["state"]
        print(f"Loaded best model {best} (epoch {ck['epoch']})")
    correct = total = 0
    preds_all, labels_all = [], []
    test_idx = np.arange(len(testset))
    for images, labels in pipeline.batches(
            testset, test_idx, max(cfg.test_batch_size, 2), shuffle=False,
            drop_remainder=False):
        _, logits = eval_step(params, state, jnp.asarray(images),
                              jnp.asarray(labels.astype(np.int32)))
        preds = np.argmax(np.asarray(logits), 1)
        correct += int((preds == labels).sum())
        total += len(labels)
        preds_all.append(preds)
        labels_all.append(labels)
    print(f"Test Acc: {correct}/{total} ({100.0*correct/max(total,1):.2f}%)")
    if cfg.dataset in ("cifar10", "Imagenette", "synthetic"):
        # confusion-matrix heatmap (reference train.py:418-419)
        from .viz import confusion_heatmap
        confusion_heatmap(ckpt_dir, np.concatenate(labels_all),
                          np.concatenate(preds_all), testset.classes)
    print("Done")


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted")
        sys.exit(130)
