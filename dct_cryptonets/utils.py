"""Training utilities: meters, early stopping, accuracy, LR schedule, and
the persistent compile cache.

Behavioral parity with the reference's utils.py:74-138 (running accuracy
meters, validation-loss early stopping with patience/threshold, top-k
accuracy, step-decay LR), re-expressed host-side and framework-agnostic.
"""
import os

import numpy as np


def enable_compile_cache():
    """Persistent XLA compile cache for the entry points: an encrypted-eval
    run compiles tens of distinct (batch-chunk, knob, shift) executables,
    and caching them on disk makes reruns and sweep resumes start hot.
    ``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise the cache lives
    at the fixed ``<checkout>/.jax_cache`` (the path is part of the key)."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def require_gpu():
    """The first JAX device and the card's ``name, power.limit`` line from
    nvidia-smi.  Measurement entry points call this first: with no GPU
    they exit non-zero instead of measuring the CPU."""
    import subprocess

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} "
                         f"({dev.device_kind})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return dev, smi.stdout.strip().splitlines()[dev.id]


class AverageMeter:
    """Weighted running average over a stream of (value, weight) updates.

    Same contract as the reference's loss/top-k meters (utils.py:74-89):
    ``update(v, n)`` folds in a batch mean over ``n`` samples, ``avg`` is
    the sample-weighted mean so far.
    """

    __slots__ = ("_total", "_weight", "last")

    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._weight = 0
        self.last = None

    def update(self, value, n=1):
        self.last = float(value)
        self._total += float(value) * n
        self._weight += n

    @property
    def avg(self):
        return self._total / self._weight if self._weight else 0.0


class EarlyStopper:
    """Stop when validation loss hasn't recovered for ``patience`` epochs.

    Reference semantics (utils.py:92-108): an epoch counts against the
    streak only when it exceeds the best loss by more than ``threshold``;
    any new best resets the streak.
    """

    def __init__(self, patience=10, threshold=0.03):
        self.patience = patience
        self.threshold = threshold
        self._best = float("inf")
        self._streak = 0

    def __call__(self, val_loss) -> bool:
        if val_loss < self._best:
            self._best = val_loss
            self._streak = 0
            return False
        if val_loss > self._best + self.threshold:
            self._streak += 1
        return self._streak >= self.patience


def topk_accuracy(logits, targets, ks=(1, 5)):
    """Top-k accuracy in percent (reference utils.py:111-124)."""
    logits = np.asarray(logits)
    targets = np.asarray(targets)
    maxk = min(max(ks), logits.shape[1])
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = pred == targets[:, None]
    out = []
    for k in ks:
        kk = min(k, logits.shape[1])
        out.append(100.0 * correct[:, :kk].any(axis=1).mean())
    return out


def step_decay_lr(base_lr, schedule, gamma, epoch):
    """LR after step decays at `schedule` epochs (reference utils.py:127-133,
    applied with epoch+1 semantics)."""
    lr = base_lr
    if schedule:
        for e in schedule:
            if epoch + 1 >= e:
                lr *= gamma
    return lr
