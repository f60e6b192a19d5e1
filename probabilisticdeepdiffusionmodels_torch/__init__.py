"""PyTorch port of probabilisticdeepdiffusionmodels_tpu for NVIDIA Hopper.

Slice 1: schedule -> respacing -> UNet forward -> ancestral reverse loop,
with the three Pallas TPU kernels of the UNet forward replaced by
hand-written CUDA kernels (``csrc/``).  Slice 2: the eps-MSE train step
(``train/``, ``engine.py``) with gradients through those kernels, and the
fourth Pallas kernel, the matrix-unit probe (``ops/probe_mma.py``).  The JAX
package stays the reference the port is tested against; this package
imports nothing of it.
"""
