#!/usr/bin/env python
"""Smoke run of the system on NVIDIA GPUs: the flagship's main path through
the entry points a user calls, and every kernel of that path checked
against its plain reference at real widths.

    python chip_smoke.py               # one card (train, image, kernels)
    python chip_smoke.py --four-cards  # the four-card path only

One card (the flagship: ResNet20qat on 24x16^2 DCT input, 6-bit exact
rounding, the audit drop policy, main lattice preset 6, extraction lattice
k2n512f):

1. train   — 3 steps of the README's training command at batch 128 on
             synthetic data; the loss must stay finite.
2. image   — one digits test image through ``homomorphic_eval.main_impl``
             with ``--fhe_mode execute --drop_policy audit --slip_audit`` on
             the committed checkpoint: compile, keygen, encryption, levelled
             ops, extraction and main bootstraps, decryption.  The
             encrypted prediction must equal the simulator's, and the
             realized TLU slips must stay within the audited p_error.
3. kernels — reusing the image's keys: a 2048-sample main bootstrap batch
             and a 4096-sample extraction batch must decrypt correctly and
             agree bit for bit with the same code on the CPU device (an
             8-sample slice); the levelled ciphertext conv and the
             simulator's conv/pool on the flagship's widest layer must equal
             numpy int64; and one CMUX step is timed beside a plain int8
             GEMM of the same shape.

Four cards: ``CompiledModule.shard_over`` encrypted execute of a tiny
circuit and one flagship-shaped bootstrap batch, each bit-exact against one
card, and one data-parallel train step against one card.

Each phase prints its time.  The script imports JAX once, keeps every
reference computation in this process on ``jax.devices("cpu")``, exits
non-zero without a result line when JAX finds no GPU or any phase fails,
and prints as its last line
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "checkpoints", "digits_flagship", "best.tar")
FLAGSHIP = ["--dct_status", "--model", "ResNet20qat", "--channels", "24",
            "--filter_size", "4", "--image_size_dct", "16"]
PRECISION = [
    "ciphertext ops (external product, keyswitch, levelled conv): int8 x "
    "int8 GEMMs with int32 accumulation, no float",
    "simulator conv: f32 at Precision.HIGHEST (no TF32); simulator pool: "
    "f32 reduce_window of integers",
    "codec DCT/resize matmuls: f32 at Precision.HIGHEST",
    "model training convs/matmuls: the GPU default (TF32 for f32)",
]


def log(msg):
    print(msg, flush=True)


def phase(name, fn, *args):
    t = time.time()
    log(f"== phase {name}")
    out = fn(*args)
    log(f"== phase {name} ok: {time.time() - t:.1f} s")
    return out


# ---------------------------------------------------------------------------
# references


def conv_int64(x, w, stride, padding):
    """NHWC x HWIO integer convolution in numpy int64 (wraps mod 2^64)."""
    kh, kw, _, co = w.shape
    xp = np.pad(x, ((0, 0), (padding, padding), (padding, padding), (0, 0)))
    oh = (x.shape[1] + 2 * padding - kh) // stride + 1
    ow = (x.shape[2] + 2 * padding - kw) // stride + 1
    out = np.zeros((x.shape[0], oh, ow, co), np.int64)
    with np.errstate(over="ignore"):
        for dy in range(kh):
            for dx in range(kw):
                win = xp[:, dy:dy + (oh - 1) * stride + 1:stride,
                         dx:dx + (ow - 1) * stride + 1:stride]
                out += np.einsum("bhwc,co->bhwo", win, w[dy, dx])
    return out


def on_cpu(fn, *args, **kw):
    """``fn`` with its array arguments committed to the CPU device."""
    import jax
    cpu = jax.devices("cpu")[0]
    return fn(*jax.device_put(args, cpu), **kw)


# ---------------------------------------------------------------------------
# one card


def train_steps(batch=128, steps=3, extra=()):
    """The trainer's jitted step as the README command builds it."""
    import jax
    import jax.numpy as jnp
    from dct_cryptonets.config import parse_args
    from dct_cryptonets.data import CodecConfig, pipeline
    from dct_cryptonets.models import build_spec, init_model
    from dct_cryptonets.train import make_optimizer, make_steps

    cfg = parse_args("train", ["--dataset", "synthetic", *FLAGSHIP,
                               "--train_aug", "--batch_size", str(batch),
                               *extra])
    codec = CodecConfig(cfg.channels, cfg.filter_size, cfg.image_size_dct,
                        cfg.dct_pattern)
    spec = build_spec(cfg.model, in_channels=cfg.channels,
                      img_size=cfg.image_size_dct,
                      num_classes=cfg.num_classes, bit_width=cfg.bit_width)
    params, state = init_model(jax.random.key(0), spec)
    opt = make_optimizer(cfg, cfg.lr)
    opt_state = opt.init(params)
    train_step, _ = make_steps(spec, cfg, codec, opt, cfg.dropout)
    ds = pipeline.load_synthetic(batch * steps, codec.pixel_size,
                                 cfg.num_classes, seed=0)
    key = jax.random.key(1234)
    for i in range(steps):
        t = time.time()
        sl = slice(i * batch, (i + 1) * batch)
        key, sk = jax.random.split(key)
        params, state, opt_state, loss, _ = train_step(
            params, state, opt_state, sk, jnp.asarray(ds.images[sl]),
            jnp.asarray(ds.labels[sl]))
        loss = float(loss)
        log(f"train step {i}: loss {loss:.5f} ({time.time() - t:.2f} s)")
        assert np.isfinite(loss), loss


def encrypted_image(extra=()):
    """One test image through the evaluation entry point."""
    import jax.numpy as jnp
    from dct_cryptonets.config import parse_args
    from dct_cryptonets.homomorphic_eval import main_impl

    cfg = parse_args("homomorphic_eval", [
        "--dataset", "digits", *FLAGSHIP, "--checkpoint_path", CHECKPOINT,
        "--fhe_mode", "execute", "--test_subset", "1",
        "--drop_policy", "audit", "--slip_audit", *extra])
    res = main_impl(cfg)
    module = res["module"]
    images, _ = res["testset"].gather(res["test_idx"])
    feats = module.forward(np.asarray(res["ingest"](jnp.asarray(images))),
                           fhe="simulate")
    clf_w, clf_b = res["classifier"]
    sim_pred = np.argmax(feats @ clf_w + clf_b, axis=1).tolist()
    s = module.stats
    log(f"image: encrypted prediction {res['enc_test_pred']}, simulate "
        f"{sim_pred}; slips {s['tlu_slips']}/{s['tlu_sites']}; execute "
        f"{s['execute_time']:.3f} s, levelled {s['levelled_time']:.3f} s, "
        f"PBS {s['pbs_time']:.3f} s ({s['pbs_executed']} main + "
        f"{s.get('aux_pbs_executed', 0)} extraction bootstraps), keygen "
        f"{s['keygen_time']:.3f} s")
    assert res["enc_test_pred"] == sim_pred, (res["enc_test_pred"], sim_pred)
    assert s["tlu_slips"] <= module.p_error * s["tlu_sites"], s["tlu_slips"]
    return module


def check_bootstrap(module, M, n_ref=8, bits=4, drop=2, cross=1):
    """A main-lattice bootstrap batch: every sample decrypts to its table
    entry; a slice equals the CPU.  4-bit tables keep the input windows
    4x wider than the lattice's rated 6 bits, where keyswitch and
    mod-switch noise alone misread ~1 % of fresh inputs by design (the
    p_error the audit budgets).  Drop 2 + cross skip run the engine's
    limb-drop paths while their output noise (~2^44) stays far below the
    2^58 decode margin."""
    import jax
    import jax.numpy as jnp
    from dct_cryptonets.fhe import torus as T
    from dct_cryptonets.fhe.keys import Csprng, decrypt_lwe, encrypt_lwe
    from dct_cryptonets.fhe.pbs import bootstrap

    p, ck = module.params, module.client_keys
    rng = np.random.default_rng(1)
    msgs = rng.integers(0, 2 ** bits, M)
    tables = rng.integers(-2 ** (bits - 1), 2 ** (bits - 1),
                          (M, 2 ** bits)).astype(np.int32)
    dlog = 63 - bits
    ct = T.from_u64(encrypt_lwe(ck, msgs.astype(np.uint64) << np.uint64(dlog),
                                Csprng(3), key=ck.big_lwe_key,
                                noise_log2=p.glwe_noise_log2))
    tb = jnp.asarray(tables)
    run = lambda c, t, k: bootstrap(c, t, k, p, dlog, drop, cross)  # noqa
    t0 = time.time()
    out = jax.block_until_ready(run(ct, tb, module.device_keys))
    t1 = time.time()
    out = jax.block_until_ready(run(ct, tb, module.device_keys))
    t2 = time.time()
    log(f"main bootstrap M={M} n={p.lwe_dim} N={p.poly_size} drop={drop} "
        f"cross={cross}: first call {t1 - t0:.3f} s, warm {t2 - t1:.3f} s "
        f"({M / (t2 - t1):.1f} PBS/s)")
    got = T.to_u64(out)
    phase_ = decrypt_lwe(ck, got, key=ck.big_lwe_key).view(np.int64)
    dec = np.round(phase_ / 2.0 ** dlog).astype(np.int64)
    dec = (dec + 2 ** bits) % 2 ** (bits + 1) - 2 ** bits
    want = tables[np.arange(M), msgs]
    assert np.array_equal(dec, want), int(np.sum(dec != want))
    ref = on_cpu(run, T.T64(ct.hi[:n_ref], ct.lo[:n_ref]), tb[:n_ref],
                 module.device_keys)
    assert np.array_equal(T.to_u64(ref), got[:n_ref]), "GPU != CPU"
    log(f"main bootstrap: all {M} decrypt to their table entries; "
        f"{n_ref}-sample slice == CPU")


def check_extraction(module, M, n_in=13, shift=4, n_ref=8, drop=2, cross=1):
    """An exact-rounding extraction batch on the aux lattice: the low bits
    clear exactly, read at the full 2^(63 - n_in) resolution; a slice
    equals the CPU.  Drop 2 + cross skip with full keyswitch keys keep the
    injected noise (~2^44 per bit) far below that resolution (the audit's
    deeper aux knobs are priced against the main PBS's coarser windows)."""
    import jax
    from dct_cryptonets.fhe import torus as T
    from dct_cryptonets.fhe.keys import Csprng, decrypt_lwe, encrypt_lwe
    from dct_cryptonets.fhe.pbs import clear_low_bits

    ck, cfg = module.client_keys, module.exact_cfg
    kw = dict(drop_limbs=drop, cross=cross)
    rng = np.random.default_rng(2)
    v = rng.integers(0, 1 << n_in, M, dtype=np.int64)
    dlog = 63 - n_in
    ct = T.from_u64(encrypt_lwe(ck, v.astype(np.uint64) << np.uint64(dlog),
                                Csprng(4), key=ck.big_lwe_key,
                                noise_log2=module.params.glwe_noise_log2))
    run = lambda c, k: clear_low_bits(  # noqa: E731
        c, k, cfg.aux, n_in, shift, cfg.back_base_log, cfg.back_levels, **kw)
    t0 = time.time()
    out = jax.block_until_ready(run(ct, module.aux_keys))
    t1 = time.time()
    out = jax.block_until_ready(run(ct, module.aux_keys))
    t2 = time.time()
    a = cfg.aux
    log(f"extraction M={M} x {shift} bits on n={a.lwe_dim} k={a.glwe_dim} "
        f"N={a.poly_size} {kw}: first call {t1 - t0:.3f} s, warm "
        f"{t2 - t1:.3f} s ({M * shift / (t2 - t1):.1f} extractions/s)")
    got = T.to_u64(out)
    ph = decrypt_lwe(ck, got, key=ck.big_lwe_key).astype(np.float64)
    dec = np.round(ph / 2.0 ** dlog).astype(np.int64) % (1 << (n_in + 1))
    want = (v - v % (1 << shift)) % (1 << (n_in + 1))
    assert np.array_equal(dec, want), int(np.sum(dec != want))
    ref = on_cpu(run, T.T64(ct.hi[:n_ref], ct.lo[:n_ref]), module.aux_keys)
    assert np.array_equal(T.to_u64(ref), got[:n_ref]), "GPU != CPU"
    log(f"extraction: all {M} cleared exactly; {n_ref}-sample slice == CPU")


def check_convs(module, n_cols=16):
    """The flagship's widest conv (and its pool) through the levelled
    ciphertext path and the simulator, against numpy int64."""
    import jax.numpy as jnp
    from dct_cryptonets.fhe import torus as T
    from dct_cryptonets.fhe.circuit import Conv, PoolSum, _conv_int, _pool_sum
    from dct_cryptonets.fhe.runtime import _conv_limbs

    circ = module.circuit
    shapes = circ.meta["shapes"]
    op = max((o for o in circ.ops if isinstance(o, Conv)),
             key=lambda o: o.w[..., 0].size)
    H, W, C = shapes[op.x]
    n1 = module.params.big_lwe_dim + 1
    rng = np.random.default_rng(5)
    ct = rng.integers(0, 2 ** 64, (1, n1, H, W, C), dtype=np.uint64)
    t0 = time.time()
    got = T.to_u64(_conv_limbs(T.from_u64(ct), op.w, op.stride, op.padding))
    dt = time.time() - t0
    x = ct[0, :n_cols].view(np.int64)
    want = conv_int64(x, op.w.astype(np.int64), op.stride, op.padding)
    assert np.array_equal(got[0, :n_cols], want.view(np.uint64))
    log(f"levelled conv {op.out} ({H}x{W}x{C} -> {op.w.shape[-1]}, "
        f"{n1} LWE columns, {dt:.3f} s incl. compile) == int64")

    lim = 2 ** min(circ.n_budget[op.x], 8)
    xi = rng.integers(-lim, lim, (4, H, W, C))
    got = np.asarray(_conv_int(jnp.asarray(xi, jnp.int32), op.w, op.stride,
                               op.padding))
    assert np.array_equal(got, conv_int64(xi, op.w.astype(np.int64),
                                          op.stride, op.padding))
    log(f"simulator conv {op.out} == int64 (|x| < {lim})")
    for po in (o for o in circ.ops if isinstance(o, PoolSum)):
        ph, pw, pc = shapes[po.x]
        xi = rng.integers(-2 ** 15, 2 ** 15, (4, ph, pw, pc))
        got = np.asarray(_pool_sum(jnp.asarray(xi, jnp.int32), po.k))
        k = po.k
        want = xi[:, :ph // k * k, :pw // k * k].reshape(
            4, ph // k, k, pw // k, k, pc).sum(axis=(2, 4))
        assert np.array_equal(got, want)
        log(f"simulator pool {po.out} ({ph}x{pw}x{pc}, k={k}) == int64")
    for line in PRECISION:
        log(f"precision: {line}")


def time_cmux(params, M, knobs):
    """One CMUX step of the engine at real width, beside a plain int8 GEMM
    of one (digit byte, key limb) pair's shape."""
    import jax
    import jax.numpy as jnp
    from dct_cryptonets.fhe import pbs as P
    from dct_cryptonets.fhe import torus as T

    k, N, lev = params.glwe_dim, params.poly_size, params.pbs_levels
    rows = (k + 1) * lev
    key = jax.random.split(jax.random.key(0), 4)
    acc = T.T64(jax.random.bits(key[0], (M, k + 1, N), jnp.uint32),
                jax.random.bits(key[1], (M, k + 1, N), jnp.uint32))
    a = jax.random.randint(key[2], (M,), 0, 2 * N).astype(jnp.uint32)
    bsk = jax.random.randint(key[3], (rows, k + 1, 2 * N, 8), -128, 128,
                             jnp.int8)

    def timed(f, *args, iters=10):
        jax.block_until_ready(f(*args))
        t = time.time()
        for _ in range(iters):
            out = f(*args)
        jax.block_until_ready(out)
        return (time.time() - t) / iters

    K, Nout = rows * N, (k + 1) * N
    lhs = jax.random.randint(key[0], (M, K), -128, 128, jnp.int8)
    rhs = jax.random.randint(key[1], (K, Nout), -128, 128, jnp.int8)
    gemm = jax.jit(lambda x, y: jax.lax.dot(
        x, y, preferred_element_type=jnp.int32))
    dt_g = timed(gemm, lhs, rhs)
    rate_g = 2 * M * K * Nout / dt_g / 1e12
    log(f"plain int8 GEMM {M}x{K}x{Nout}: {dt_g * 1e3:.3f} ms, "
        f"{rate_g:.1f} TOP/s")
    dbytes = P._digit_bytes_count(params.pbs_base_log)
    for drop, cross in knobs:
        pairs = sum(1 for u in range(dbytes) for v in range(8 - drop)
                    if u + v + drop < 8 and u + v >= cross)
        step = jax.jit(lambda c, a, b, d=drop, x=cross: P.cmux_accumulate(
            c, a, b, (params.pbs_base_log, lev, k, N), d, x))
        dt = timed(step, acc, a, bsk)
        rate = 2 * pairs * M * K * Nout / dt / 1e12
        log(f"CMUX step N={N} k={k} M={M} drop={drop} cross={cross}: "
            f"{dt * 1e3:.3f} ms, {pairs} GEMMs, {rate:.1f} TOP/s = "
            f"{rate / rate_g:.2f} of the plain GEMM's rate")


def kernels(module):
    import jax
    check_bootstrap(module, 2048)
    check_extraction(module, 4096)
    check_convs(module)
    drop, cross = max((r.drop_limbs, r.cross) for r in module.audit.reports)
    time_cmux(module.params, 2048, [(0, 0), (drop, cross)])
    time_cmux(module.exact_cfg.aux, 4096,
              [(0, 0), (module.aux_drop_limbs, module.aux_cross)])
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak device memory: {stats.get('peak_bytes_in_use')} bytes")


# ---------------------------------------------------------------------------
# four cards


def tiny_module():
    """The smallest circuit that exercises every encrypted stage (levelled
    convs, residual, batched TLU bootstraps, an extraction layer)."""
    import jax
    import jax.numpy as jnp
    from dct_cryptonets.fhe.params import TEST_PARAMS
    from dct_cryptonets.fhe.runtime import compile_qat_model
    from dct_cryptonets.models import calibrate_scales, init_model
    from dct_cryptonets.models.resnet import ModelSpec, forward
    from dct_cryptonets.models.topology import StemSpec

    tiny = ModelSpec(name="tinyqat", block_counts=(1,), widths=(4,),
                     in_channels=3, img_size=2, num_classes=4, bit_width=3,
                     quantized=True,
                     stem_override=StemSpec(1, 1, 0, None, None, 2,
                                            relu1=True))
    params, state = init_model(jax.random.key(2), tiny)
    xq = np.clip(np.random.default_rng(3).normal(0, 0.7, (4, 2, 2, 3)),
                 -2, 2).astype(np.float32)
    for _ in range(2):
        _, _, state = forward(params, state, jnp.asarray(xq), tiny,
                              train=True)
    params = calibrate_scales(params, state, jnp.asarray(xq), tiny)
    module = compile_qat_model(params, state, tiny, n_bits=3,
                               rounding_threshold_bits=5, calib_data=xq,
                               tfhe_params=TEST_PARAMS, pbs_batch=4096)
    module.keygen(seed=0)
    return module, xq


def sharded_execute(n):
    from dct_cryptonets.fhe.keys import Csprng
    from dct_cryptonets.parallel import data_mesh

    module, xq = tiny_module()
    sim = module.forward(xq, fhe="simulate")
    one = module.forward(xq, fhe="execute", enc_rng=Csprng(5))
    mesh = data_mesh(n)
    module.shard_over(mesh)
    many = module.forward(xq, fhe="execute", mesh=mesh, enc_rng=Csprng(5))
    assert np.array_equal(one, many), "sharded execute != one card"
    assert np.array_equal(one, sim), "execute != simulate"
    log(f"sharded execute on {n} cards == one card == simulate "
        f"({module.circuit.num_pbs} PBS/sample)")


def sharded_bootstrap(n, params=None, M=2048):
    """One flagship-shaped bootstrap batch (preset 6, M=2048) with random
    key bytes: the batch sharded over n cards against one card, bit for
    bit (the comparison needs no valid keys)."""
    import jax
    import jax.numpy as jnp
    from dct_cryptonets.fhe import torus as T
    from dct_cryptonets.fhe.params import params_for_precision
    from dct_cryptonets.fhe.pbs import DeviceServerKeys, bootstrap
    from dct_cryptonets.parallel import data_mesh, replicate, shard_batch

    p = params or params_for_precision(6)
    k, N, n_lwe = p.glwe_dim, p.poly_size, p.lwe_dim
    rows = (k + 1) * p.pbs_levels
    key = jax.random.split(jax.random.key(7), 5)
    dsk = DeviceServerKeys(
        jax.random.randint(key[0], (n_lwe, rows, k + 1, 2 * N, 8), -128, 128,
                           jnp.int8),
        jax.random.randint(key[1], (k * N * p.ks_levels, n_lwe + 1, 8), -128,
                           128, jnp.int8))
    ct = T.T64(jax.random.bits(key[2], (M, k * N + 1), jnp.uint32),
               jax.random.bits(key[3], (M, k * N + 1), jnp.uint32))
    tables = jax.random.randint(key[4], (M, 2 ** p.message_bits), -32, 32,
                                jnp.int32)
    outs = {}
    for nd in (1, n):
        mesh = data_mesh(nd)
        t = time.time()
        out = bootstrap(T.T64(*shard_batch(mesh, list(ct))),
                        shard_batch(mesh, tables),
                        DeviceServerKeys(*replicate(mesh, list(dsk))), p, 57,
                        2, 1)
        outs[nd] = T.to_u64(out)
        log(f"bootstrap M={M} N={N} on {nd} card(s): {time.time() - t:.3f} s "
            f"incl. compile")
    assert np.array_equal(outs[1], outs[n]), "sharded bootstrap != one card"
    log(f"bootstrap batch sharded over {n} cards == one card, bit for bit")


def sharded_train_step(n, batch=128):
    """One data-parallel step of the trainer against one card.  SGD makes
    the parameter update proportional to the all-reduced gradient.  Both
    run in full f32 (no TF32); the sums still run in another order across
    cards and a fake-quant rounding can flip with them, so the updates are
    compared by relative L2 norm (a gradient reduced over one shard only
    would miss by O(1))."""
    import argparse

    import jax
    from dct_cryptonets.data import CodecConfig, pipeline
    from dct_cryptonets.models import build_spec, init_model
    from dct_cryptonets.parallel import data_mesh, replicate, shard_batch
    from dct_cryptonets.train import make_optimizer, make_steps

    cfg = argparse.Namespace(optimizer="sgd", weight_decay=0.0, momentum=0.9,
                             grad_clip_value=None, grad_clip_norm=None,
                             train_aug=True)
    codec = CodecConfig(channels=24, filter_size=4, image_size_dct=16)
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16,
                      num_classes=10, bit_width=4)
    # host copies: the step donates its parameter buffers
    params0, state0 = jax.device_get(init_model(jax.random.key(0), spec))
    ds = pipeline.load_synthetic(batch, codec.pixel_size, 10, seed=0)
    res = {}
    for nd in (1, n):
        mesh = data_mesh(nd)
        opt = make_optimizer(cfg, 0.1)
        train_step, _ = make_steps(spec, cfg, codec, opt, None)
        params, state = replicate(mesh, (params0, state0))
        opt_state = replicate(mesh, opt.init(params0))
        images, labels = shard_batch(mesh, (ds.images, ds.labels))
        key = jax.device_put(jax.random.key(3),
                             jax.sharding.NamedSharding(
                                 mesh, jax.sharding.PartitionSpec()))
        with jax.default_matmul_precision("float32"):
            params, _, _, loss, _ = train_step(params, state, opt_state, key,
                                               images, labels)
        res[nd] = (float(loss), jax.device_get(params))
        log(f"train step on {nd} card(s): loss {res[nd][0]:.6f}")
    l1, p1 = res[1]
    ln, pn = res[n]
    assert abs(ln - l1) <= 1e-4 * abs(l1), (l1, ln)
    u1 = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), p1, params0))
    un = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), pn, params0))
    scale = np.sqrt(sum(float(np.sum(u.astype(np.float64) ** 2))
                        for u in u1))
    err = np.sqrt(sum(float(np.sum((a - b).astype(np.float64) ** 2))
                      for a, b in zip(u1, un)))
    log(f"train step: |update({n}) - update(1)| / |update(1)| = "
        f"{err / scale:.3e} (L2)")
    assert scale > 0 and err <= 5e-2 * scale, (err, scale)


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path and its comparisons")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    import jax
    from dct_cryptonets.utils import enable_compile_cache, require_gpu

    enable_compile_cache()
    dev, card = require_gpu()
    log(card)
    log(f"device_kind: {dev.device_kind}; {len(jax.devices())} device(s)")
    t0 = time.time()
    n = len(jax.devices())
    if args.four_cards:
        assert n == 4, f"--four-cards needs 4 GPUs, JAX sees {n}"
        phase("sharded execute", sharded_execute, n)
        phase("sharded bootstrap", sharded_bootstrap, n)
        phase("sharded train step", sharded_train_step, n)
    else:
        phase("train", train_steps)
        module = phase("image", encrypted_image)
        phase("kernels", kernels, module)
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n}}),
        flush=True)


if __name__ == "__main__":
    main()
