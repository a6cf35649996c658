#!/usr/bin/env python
"""Empirically isolate blind-rotate output noise per (drop_limbs, cross).

A CONSTANT test polynomial makes window slips invisible, so the decrypted
phase residual is exactly the blind-rotate output noise — the quantity
NoiseModel.var_blind_rotate / var_drop_limbs / var_drop_cross predict.
Run on the accelerator with cached bench keys (``python
tools/measure_drop_noise.py``).  The arithmetic is exact, so the measured
noise does not depend on the device; the measurements recorded in the model
docstrings (fhe/params.py) came from this tool.
"""
import sys
sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))))
import numpy as np, jax.numpy as jnp
from dct_cryptonets.fhe import torus as T
from dct_cryptonets.fhe.keys import encrypt_lwe, decrypt_lwe
from dct_cryptonets.fhe.params import params_for_precision, NoiseModel
from dct_cryptonets.fhe.pbs import bootstrap
import importlib.util
spec = importlib.util.spec_from_file_location("bench", __import__("os").path.join(__import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))), "bench.py"))
bench = importlib.util.module_from_spec(spec); spec.loader.exec_module(bench)

params = params_for_precision(6)
ck, dsk = bench.get_keys(params)
nm = NoiseModel(params)
M, bits = 2048, 6
rng = np.random.default_rng(11)
msgs = rng.integers(0, 2 ** bits, M)
mu = msgs.astype(np.uint64) << np.uint64(64 - bits - 1)
ct = T.from_u64(encrypt_lwe(ck, mu, rng, key=ck.big_lwe_key,
                            noise_log2=params.glwe_noise_log2))
# constant table: window slips are invisible -> residual = BR output noise
C = 17
table = np.full((M, 2 ** bits), C, np.int32)
delta_out = params.delta_log2
for drop, cross in [(0, 0), (3, 0), (3, 1), (4, 0), (4, 1)]:
    out = bootstrap(ct, jnp.asarray(table), dsk, params, delta_out,
                    drop_limbs=drop, cross=cross)
    phase = decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
    want = np.uint64(C) << np.uint64(delta_out)
    err = (phase - want).astype(np.int64)
    sigma = err.std()
    pred = (nm.var_blind_rotate() + nm.var_drop_limbs(drop)
            + (nm.var_drop_cross(drop) if cross else 0.0)) ** 0.5
    print(f"drop={drop} cross={cross}: measured sigma 2^{np.log2(max(sigma,1)):.2f} "
          f"model 2^{np.log2(pred):.2f}")
