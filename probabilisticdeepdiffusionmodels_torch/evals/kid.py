"""Kernel Inception Distance (KID, arXiv:1801.01401).

A numpy copy of ``probabilisticdeepdiffusionmodels_tpu/evals/kid.py`` (no
framework in it, so the port keeps its own): the unbiased MMD^2 between two
feature sets under the cubic polynomial kernel k(x, y) = (x.y / d + 1)^3,
reported as mean and std over random subsets drawn by
``np.random.default_rng(seed)``.  The same features and seed give JAX's
bits.  The expensive part, the Inception forward, already ran on the
device; the kernel sums are a few n^2 d flops on subsets.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["polynomial_mmd2", "kernel_inception_distance"]


def _poly_kernel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(x.y / d + 1)^3 gram block; d = feature dimension."""
    d = a.shape[1]
    return (a @ b.T / d + 1.0) ** 3


def polynomial_mmd2(x: np.ndarray, y: np.ndarray) -> float:
    """Unbiased MMD^2 between ``x`` (n, d) and ``y`` (m, d) under the cubic
    polynomial kernel, the diagonal terms left out of the within-set sums."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n, m = len(x), len(y)
    if n < 2 or m < 2:
        raise ValueError(f"need >=2 rows per side for the unbiased "
                         f"estimator, got {n} and {m}")
    k_xx = _poly_kernel(x, x)
    k_yy = _poly_kernel(y, y)
    k_xy = _poly_kernel(x, y)
    return float(
        (k_xx.sum() - np.trace(k_xx)) / (n * (n - 1))
        + (k_yy.sum() - np.trace(k_yy)) / (m * (m - 1))
        - 2.0 * k_xy.mean()
    )


def kernel_inception_distance(
    real: np.ndarray,
    fake: np.ndarray,
    subset_size: int = 1000,
    n_subsets: int = 100,
    seed: int = 0,
) -> Dict[str, float]:
    """KID as mean and std of the unbiased MMD^2 over ``n_subsets`` subsets
    of ``subset_size`` rows per side (without replacement within a subset,
    independent across subsets).  ``subset_size`` is clamped to the smaller
    side; where both sides fit in one subset, MMD^2 is computed once and the
    std is 0.  The clamp and the count are reported."""
    real = np.asarray(real)
    fake = np.asarray(fake)
    if real.ndim != 2 or fake.ndim != 2 or real.shape[1] != fake.shape[1]:
        raise ValueError(
            f"expected (n, d) feature matrices with equal d, got "
            f"{real.shape} and {fake.shape}"
        )
    m = int(min(subset_size, len(real), len(fake)))
    if m >= len(real) and m >= len(fake):
        return {
            "kid_mean": polynomial_mmd2(real, fake),
            "kid_std": 0.0,
            "kid_subset_size": m,
            "kid_n_subsets": 1,
        }
    rng = np.random.default_rng(seed)
    vals = np.empty((n_subsets,), np.float64)
    for i in range(n_subsets):
        r = real[rng.choice(len(real), m, replace=False)]
        f = fake[rng.choice(len(fake), m, replace=False)]
        vals[i] = polynomial_mmd2(r, f)
    return {
        "kid_mean": float(vals.mean()),
        "kid_std": float(vals.std()),
        "kid_subset_size": m,
        "kid_n_subsets": int(n_subsets),
    }
