"""Improved precision and recall (Kynkäänniemi et al., arXiv:1904.06991).

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/evals/prd.py``.
A point y lies on the manifold of a feature set X if ||y - x_j|| <= r_j for
some j, r_j the distance of x_j to its k-th nearest neighbour in X:
precision is the share of generated points on the real manifold, recall the
share of real points on the generated one.  Each direction is one [N, M]
distance matrix (one product) and a ``topk`` of k + 1 (the self-distance 0
included), in float32 on the features' device, TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from .inception import true_float32

__all__ = ["knn_precision_recall"]


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, D], [M, D] -> [N, M] squared euclidean distances (one product)."""
    aa = torch.sum(a * a, dim=1, keepdim=True)
    bb = torch.sum(b * b, dim=1, keepdim=True)
    return torch.clamp(aa - 2.0 * (a @ b.T) + bb.T, min=0.0)


def _manifold_fraction(x: torch.Tensor, y: torch.Tensor, k: int) -> float:
    """Share of y's rows inside the k-NN manifold of x."""
    neg_topk = torch.topk(-_sq_dists(x, x), k + 1, dim=1).values
    radius = -neg_topk[:, k]  # [N] squared radii
    inside = torch.any(_sq_dists(y, x) <= radius[None, :], dim=1)
    return float(inside.float().mean())


def _features(f) -> torch.Tensor:
    if isinstance(f, torch.Tensor):
        return f.float()
    return torch.from_numpy(np.asarray(f, np.float32))


def knn_precision_recall(real, gen, k: int = 3) -> dict:
    """precision and recall of ``gen`` against ``real`` feature sets [*, D]
    (tensors, on their device, or numpy, on the host); k = 3 is the paper's
    default.  Python floats."""
    real, gen = _features(real), _features(gen)
    if real.ndim != 2 or gen.ndim != 2 or real.shape[1] != gen.shape[1]:
        raise ValueError(f"expected [*, D] feature sets of one D, got {tuple(real.shape)} and "
                         f"{tuple(gen.shape)}")
    if real.shape[0] <= k or gen.shape[0] <= k:
        raise ValueError(f"need more than k={k} points a side")
    gen = gen.to(real.device)
    with torch.no_grad(), true_float32():
        return {
            "precision": _manifold_fraction(real, gen, k),
            "recall": _manifold_fraction(gen, real, k),
        }
