"""FID: activation statistics and the Fréchet distance.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/evals/fid.py``.
The samples never leave the device as images: InceptionV3 pool features are
computed in batches on the device (``evals/inception.py``), their moments
(sum, outer-product sum, count) accumulated in float64 on the host
(``ActivationStats``, a numpy copy of JAX's), and the Fréchet distance
evaluated from them with scipy's ``sqrtm`` (``frechet_distance``, a numpy
copy of JAX's).

  * ``compute_fid_from_engine``: sample from a model, score against a
    loader's real images, optionally with improved precision and recall,
    KID and the Inception Score on the first ``pr_limit`` feature rows of
    each side;
  * ``compute_fid_for_loaders``: the FID of two real splits (the floor).

The sharded statistics of a device mesh (JAX's ``MeshActivationStats``)
raise: ROADMAP.md Queue 1 item 18.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ..data.transforms import unnormalize
from .inception import inception_pool_features, load_params, preprocess

__all__ = [
    "ActivationStats",
    "MeshActivationStats",
    "frechet_distance",
    "compute_statistics",
    "compute_fid_from_engine",
    "compute_fid_for_loaders",
]

_MESH = "is not ported yet (ROADMAP.md Queue 1 item 18)"


class ActivationStats:
    """Running first and second moments of pool features, float64 on the
    host.  The feature dim is taken from the first batch."""

    def __init__(self, dim: Optional[int] = None):
        self.s = None if dim is None else np.zeros(dim, np.float64)
        self.ss = None if dim is None else np.zeros((dim, dim), np.float64)
        self.n = 0

    def update(self, feats: np.ndarray):
        f = np.asarray(feats, np.float64)
        if self.s is None:
            dim = f.shape[-1]
            self.s = np.zeros(dim, np.float64)
            self.ss = np.zeros((dim, dim), np.float64)
        self.s += f.sum(axis=0)
        self.ss += f.T @ f
        self.n += f.shape[0]

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mu = self.s / self.n
        cov = (self.ss - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


class MeshActivationStats:
    """JAX's statistics sharded over a device mesh."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"MeshActivationStats {_MESH}")


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + tr(C1 + C2 - 2 sqrt(C1 C2)) (pytorch-fid's formula).
    JAX's copy passes ``disp=False``, which newer scipy no longer takes;
    without it scipy returns the same matrix."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(covmean))


def _make_feature_fn(inception_params) -> Callable:
    """[0, 1] NHWC images (numpy or a tensor) -> [B, 2048] pool features on
    the module's device: resized and scaled there, then the forward."""
    device = next(inception_params.buffers()).device

    def feat(x01):
        if not isinstance(x01, torch.Tensor):
            x01 = torch.from_numpy(np.ascontiguousarray(x01, np.float32))
        return inception_pool_features(inception_params, preprocess(x01.to(device)))

    return feat


def _host(f) -> np.ndarray:
    return f.detach().float().cpu().numpy() if isinstance(f, torch.Tensor) else np.asarray(f)


def compute_statistics(
    batches: Iterable[np.ndarray],
    inception_params=None,
    feature_fn: Optional[Callable] = None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, cov) of the features of ``batches``, NHWC float images in [0, 1]
    (``feature_fn`` default: the Inception pool features, the weights from
    ``load_params`` where none are given)."""
    if mesh is not None:
        raise NotImplementedError(f"mesh statistics {_MESH}")
    if feature_fn is None:
        inception_params = (
            inception_params if inception_params is not None else load_params()
        )
        feature_fn = _make_feature_fn(inception_params)
    stats = ActivationStats()
    for b in batches:
        stats.update(_host(feature_fn(torch.from_numpy(np.ascontiguousarray(b, np.float32)))))
    return stats.finalize()


def _real_batches(dataloader, normalize, limit):
    count = 0
    for x, _ in dataloader:
        x01 = unnormalize(np.asarray(x), normalize=normalize, clip=True)
        if limit is not None and count + len(x01) > limit:
            x01 = x01[: limit - count]
        count += len(x01)
        yield x01
        if limit is not None and count >= limit:
            return


def compute_fid_from_engine(
    engine,
    dataloader,
    n_samples: int = 10000,
    minibatch: int = 256,
    normalize=None,
    real_limit: int = 16384,
    inception_params=None,
    mean_only: bool = False,
    seed: int = 0,
    num_sample_steps=None,
    ddim: bool = False,
    with_precision_recall: bool = False,
    pr_limit: int = 4096,
    with_kid: bool = False,
    with_inception_score: bool = False,
    inception_provenance: Optional[str] = None,
):
    """Sample ``n_samples`` images from the engine (``minibatch`` at a time,
    seeds ``seed``, ``seed + 1``, ...) and score them against the loader's
    reals (at most ``real_limit``).  Returns the FID, a float; with any
    extra, a dict: ``fid``, ``inception_weights`` (the stamp, "ported:<md5>",
    "random" or "caller-provided"), ``extras_n_fake`` / ``extras_n_real``
    (the feature rows the extras ran on: the first ``pr_limit`` of each
    side, an extra forward of those rows) and the extras' keys:
    ``precision`` / ``recall`` (``with_precision_recall``), ``kid_*``
    (``with_kid``), ``is_*`` (``with_inception_score``, from the fake
    features alone, so no real rows are teed for IS).  The Inception
    weights load onto the engine's device where none are given."""
    if inception_params is None:
        inception_params, inception_provenance = load_params(
            with_provenance=True, device=engine.device)
    elif inception_provenance is None:
        inception_provenance = "caller-provided"
    if with_inception_score and getattr(inception_params, "fc", None) is None:
        # fail before the sampling pass, not after it
        raise ValueError("with_inception_score needs Inception weights with an 'fc' "
                         "classifier head (the loaded checkpoint has none)")
    feat = _make_feature_fn(inception_params)

    def fake_batches():
        done, s = 0, seed
        while done < n_samples:
            take = min(minibatch, n_samples - done)
            imgs = engine.generate_images(n=take, minibatch=take, mean_only=mean_only, seed=s,
                                          num_sample_steps=num_sample_steps, ddim=ddim)
            s += 1
            done += take
            # model space -> [0, 1], clipped as the reference does
            yield unnormalize(imgs, normalize=normalize, clip=True)

    fake_gen = fake_batches()
    real_gen = _real_batches(dataloader, normalize, real_limit)
    buckets = {"fake": [], "real": []}
    extras = with_precision_recall or with_kid or with_inception_score
    # the real features feed P&R and KID only
    need_real = with_precision_recall or with_kid
    if extras:
        def tee(gen, name):
            count = 0
            for b in gen:
                if count < pr_limit:
                    take = np.asarray(b)[: pr_limit - count]
                    buckets[name].append(feat(take))
                    count += len(take)
                yield b

        fake_gen = tee(fake_gen, "fake")
        if need_real:
            real_gen = tee(real_gen, "real")

    mu_f, cov_f = compute_statistics(fake_gen, feature_fn=feat)
    mu_r, cov_r = compute_statistics(real_gen, feature_fn=feat)
    fid = frechet_distance(mu_f, cov_f, mu_r, cov_r)
    if not extras:
        return fid
    out = {"fid": fid, "inception_weights": inception_provenance}
    fake_f = torch.cat(buckets["fake"])
    real_f = torch.cat(buckets["real"]) if need_real else None
    out["extras_n_fake"] = int(len(fake_f))
    if need_real:
        out["extras_n_real"] = int(len(real_f))
    if with_precision_recall:
        from .prd import knn_precision_recall

        out.update(knn_precision_recall(real_f, fake_f))
    if with_kid:
        from .kid import kernel_inception_distance

        out.update(kernel_inception_distance(_host(real_f), _host(fake_f)))
    if with_inception_score:
        from .is_score import inception_score_from_features

        out.update(inception_score_from_features(_host(fake_f), inception_params))
    return out


def compute_fid_for_loaders(loader1, loader2, normalize=None, limit: int = 16384,
                            inception_params=None, device=None) -> float:
    """The FID of two real loaders' first ``limit`` images (the floor a
    model's FID is read against); the weights from ``load_params`` on
    ``device`` (None: cuda) where none are given."""
    inception_params = (
        inception_params if inception_params is not None else load_params(device=device)
    )
    feat = _make_feature_fn(inception_params)
    mu1, cov1 = compute_statistics(_real_batches(loader1, normalize, limit), feature_fn=feat)
    mu2, cov2 = compute_statistics(_real_batches(loader2, normalize, limit), feature_fn=feat)
    return frechet_distance(mu1, cov1, mu2, cov2)
