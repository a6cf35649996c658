"""dct_cryptonets — a JAX framework for DCT-domain encrypted inference.

A from-scratch JAX/XLA re-design of the capabilities of DCT-CryptoNets
(reference: zhiyongggggg/dct-cryptonets): blockwise-DCT frequency-domain image
ingest, quantization-aware ResNet training, a bit-exact integer circuit
simulator, and a TFHE runtime (LWE/GLWE arithmetic, keyswitch, batched
programmable bootstrapping) batched into exact int8 matrix products on the
accelerator, with multi-card scale-out via jax.sharding meshes.

Subpackages
-----------
- ``data``      codec pipeline, channel-subset tables, normalization stats
- ``ops``       XLA ops (blockwise DCT, quantized conv)
- ``models``    float + QAT ResNet builders over a declarative layer graph
- ``fhe``       TFHE runtime + integer simulator + circuit compiler
- ``parallel``  device-mesh sharding helpers
"""

__version__ = "0.1.0"
