"""PyTorch port of probabilisticdeepdiffusionmodels_tpu for NVIDIA Hopper.

Slice 1: schedule -> respacing -> UNet forward -> ancestral reverse loop,
with the three Pallas TPU kernels of the UNet forward replaced by
hand-written CUDA kernels (``csrc/``).  Slice 2: the eps-MSE train step
(``train/``, ``engine.py``) with gradients through those kernels, and the
fourth Pallas kernel, the matrix-unit probe (``ops/probe_mma.py``).  Slices
3 and 4 redesigned the kernels for Hopper.  Slice 5: the run loop of the
eps / linear-schedule path, the NLL bound (``evals/``), the engine facade
(``engine.py``), the Trainer and checkpoints (``train/``), data, config and
logging, and the ``cli.train`` / ``cli.sample`` / ``cli.eval`` entry points.
Slice 6: the visualization suite (``viz/``) and the engine endpoints it
calls, and the hybrid (learned sigma), v, x0, min-SNR, zero-terminal-SNR,
class-dropout and mixed-schedule options.  The JAX package stays the
reference the port is tested against; this package imports nothing of it.
"""
