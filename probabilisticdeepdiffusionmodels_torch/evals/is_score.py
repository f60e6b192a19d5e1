"""Inception Score (IS, arXiv:1606.03498 section 4).

A numpy copy of ``probabilisticdeepdiffusionmodels_tpu/evals/is_score.py``:
IS = exp(E_x KL(p(y|x) || p(y))), mean and std over ``splits`` equal chunks.
The classifier head is one linear layer on the 2048-d pool features, so IS
reads the same teed features as FID, P&R and KID: logits = feats @ fc.w +
fc.b, in float64 on the host, which gives JAX's bits.  With random Inception
weights the value is not comparable to published numbers, as FID is not.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["inception_score_from_logits", "inception_score_from_features"]


def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def inception_score_from_logits(
    logits: np.ndarray, splits: int = 10
) -> Dict[str, float]:
    """IS mean/std over ``splits`` chunks of ``logits`` [n, num_classes]:
    each chunk exp(mean_i KL(p(y|x_i) || mean_j p(y|x_j))), KL in nats."""
    logits = np.asarray(logits, np.float64)
    if logits.ndim != 2:
        raise ValueError(f"expected [n, classes] logits, got {logits.shape}")
    n = len(logits)
    splits = int(min(splits, n // 2)) or 1
    if n < 2:
        raise ValueError("need >=2 samples for an inception score")
    # softmax can underflow to 0.0, and 0 * log(0) is NaN; 1e-300 keeps
    # such an entry's p log p at ~0
    probs = np.maximum(_softmax(logits), 1e-300)
    scores = []
    for chunk in np.array_split(probs, splits):
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = np.sum(chunk * (np.log(chunk) - np.log(marginal)), axis=1)
        scores.append(float(np.exp(kl.mean())))
    scores = np.asarray(scores)
    return {
        "is_mean": float(scores.mean()),
        "is_std": float(scores.std()),
        "is_splits": int(splits),
    }


def inception_score_from_features(
    pool_features: np.ndarray, inception_params, splits: int = 10
) -> Dict[str, float]:
    """IS from [n, 2048] pool features and the Inception module's ``fc``
    head ([in, out]), applied in float64."""
    fc = getattr(inception_params, "fc", None)
    if fc is None:
        raise ValueError(
            "the Inception weights have no 'fc' head — load a checkpoint (or "
            "random_params) that includes the classifier"
        )
    w = fc.w.detach().cpu().numpy().astype(np.float64)
    b = fc.b.detach().cpu().numpy().astype(np.float64)
    logits = np.asarray(pool_features, np.float64) @ w + b
    return inception_score_from_logits(logits, splits=splits)
