"""TFHE runtime, integer circuit simulator, and circuit compiler.

This package re-owns the role of Concrete-ML / Concrete (the MLIR compiler +
native TFHE runtime the reference delegates to at
``homomorphic_eval.py:22-23, 276-316``), re-designed for batched
accelerator execution:

- ``params``     TFHE parameter sets + noise model + p_error accounting
- ``torus``      mod-2^64 torus arithmetic as (hi, lo) int32 limb pairs
- ``keys``       client-side key generation, encryption, decryption (numpy)
- ``pbs``        batched blind rotate / sample extract / keyswitch / PBS (JAX)
- ``simulator``  bit-exact pure-integer circuit evaluation (the oracle)
- ``compiler``   QAT model -> levelled-op + TLU circuit ("compile_qat_model")
- ``runtime``    encrypted execution of compiled circuits
"""
from .params import TFHEParams, NoiseModel, params_for_precision  # noqa: F401
