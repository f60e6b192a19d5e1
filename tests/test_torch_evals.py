"""The port's FID family against the JAX package: InceptionV3 (the weight
port, the features and logits, ``preprocess``), the scores (FID's moments
and distance, KID, IS, improved precision and recall), the pipeline
(``compute_fid_from_engine``, ``compute_fid_for_loaders``) on a stub
engine, and ``cli.fid_score`` / ``cli.fid_debug`` end to end.

Tolerances: the features and logits through ``inception_from_jax`` within
2e-3 absolute and 1e-3 relative (JAX's own, tests/test_evals.py), and within
1e-4 of their largest value; ``preprocess`` within 1e-5; the numpy scores
(``ActivationStats``, ``frechet_distance``, KID, IS) bit for bit; P&R
exactly, on features whose k-NN radii lie at least 1e-4 (relative) from
every distance compared with them; the pipeline on a cheap feature function
within 1e-5 relative.  The full Inception forward is too slow for the CLI
tests, which patch a cheap feature function in, as tests/test_cli.py does.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probabilisticdeepdiffusionmodels_tpu.evals import fid as J_fid
from probabilisticdeepdiffusionmodels_tpu.evals import inception as J_inc
from probabilisticdeepdiffusionmodels_tpu.evals import is_score as J_is
from probabilisticdeepdiffusionmodels_tpu.evals import kid as J_kid
from probabilisticdeepdiffusionmodels_tpu.evals import prd as J_prd
from probabilisticdeepdiffusionmodels_torch.cli import fid_debug as cli_fid_debug
from probabilisticdeepdiffusionmodels_torch.cli import fid_score as cli_fid_score
from probabilisticdeepdiffusionmodels_torch.convert import inception_from_jax
from probabilisticdeepdiffusionmodels_torch.evals import fid as P_fid
from probabilisticdeepdiffusionmodels_torch.evals import inception as P_inc
from probabilisticdeepdiffusionmodels_torch.evals import is_score as P_is
from probabilisticdeepdiffusionmodels_torch.evals import kid as P_kid
from probabilisticdeepdiffusionmodels_torch.evals import prd as P_prd
from test_cli import TINY
from test_torch_cli import write_run
from test_torch_threads import one_torch_thread  # noqa: E402,F401

CPU = ["device=cpu"]


@pytest.fixture(scope="module")
def state_dict():
    """A pytorch-fid-named state dict with non-trivial BatchNorm statistics
    (the JAX package's own test scaffolding draws the weights)."""
    from _torch_inception import FIDInceptionTorch

    torch.manual_seed(0)
    sd = FIDInceptionTorch().state_dict()
    g = torch.Generator().manual_seed(1)
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k] = torch.randn(sd[k].shape, generator=g) * 0.1
        elif k.endswith("running_var"):
            sd[k] = torch.rand(sd[k].shape, generator=g) + 0.5
        elif k == "fc.weight":
            sd[k] = torch.randn(sd[k].shape, generator=g) / 2048 ** 0.5
    return sd


@pytest.fixture(scope="module")
def jax_inception(state_dict):
    """JAX's param tree of that state dict, an input at 2x299x299 in
    [-1, 1], and JAX's pool features and logits on it (one compile)."""
    params = J_inc.params_from_torch_state_dict(state_dict)
    x = np.random.RandomState(0).uniform(-1.0, 1.0, (2, 299, 299, 3)).astype(np.float32)
    both = jax.jit(lambda p, xx: (J_inc.inception_pool_features(p, xx),
                                  J_inc.inception_logits(p, xx)))
    feats, logits = both(params, jnp.asarray(x))
    return jax.tree.map(np.asarray, params), x, np.asarray(feats), np.asarray(logits)


# ------------------------------------------------------------- Inception


def test_inception_features_and_logits_match_jax(jax_inception):
    params, x, feats, logits = jax_inception
    model = inception_from_jax(params, device="cpu")
    got = P_inc.inception_pool_features(model, torch.from_numpy(x)).numpy()
    got_logits = P_inc.inception_logits(model, torch.from_numpy(x)).numpy()
    for g, w in ((got, feats), (got_logits, logits)):
        assert g.shape == w.shape and np.isfinite(w).all()
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=1e-3)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    assert got.shape == (2, 2048) and got_logits.shape == (2, 1008)


def test_params_from_torch_state_dict_matches_jax(state_dict, jax_inception):
    """The BatchNorm fold and the layouts, bit for bit: OIHW against JAX's
    HWIO, the fc head [in, out] as JAX stores it."""
    params = jax_inception[0]
    got = P_inc.params_from_torch_state_dict(state_dict, device="cpu").state_dict()
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[".".join(prefix + (k,))] = v

    walk(params, ())
    assert set(got) == set(flat)
    for k, want in flat.items():
        want = want.transpose(3, 2, 0, 1) if want.ndim == 4 else want
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)


@pytest.mark.parametrize("size,channels", [(32, 3), (28, 1), (64, 3), (400, 3), (299, 3)],
                         ids=["cifar32", "mnist28_grey", "celeba64", "shrink400", "keep299"])
def test_preprocess_matches_jax(size, channels):
    """The bilinear resize to 299 (half-pixel centres; the edge rows and
    columns, where JAX renormalises its kernel, held alone too), the grey
    repeat, the [-1, 1] scale; 299 inputs are not resized."""
    x01 = np.random.RandomState(size).rand(2, size, size, channels).astype(np.float32)
    want = np.asarray(jax.jit(J_inc.preprocess)(jnp.asarray(x01)))
    got = P_inc.preprocess(torch.from_numpy(x01)).numpy()
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for edge in (got[:, [0, -1]] - want[:, [0, -1]], got[:, :, [0, -1]] - want[:, :, [0, -1]]):
        assert np.abs(edge).max() <= 1e-5
    if size == 299:
        np.testing.assert_array_equal(got, 2.0 * x01 - 1.0)


def test_load_params_provenance(state_dict, tmp_path, monkeypatch):
    """The stamp: ``ported:<md5>`` of the checkpoint file, as JAX's, or
    ``random`` without one; the bare return without ``with_provenance``."""
    path = tmp_path / "pt_inception.pth"
    torch.save(state_dict, path)
    md5 = hashlib.md5(path.read_bytes()).hexdigest()
    monkeypatch.setenv("PDDM_INCEPTION_WEIGHTS", str(path))
    model, stamp = P_inc.load_params(with_provenance=True, device="cpu")
    _, jstamp = J_inc.load_params(with_provenance=True)
    assert stamp == jstamp == f"ported:{md5}"
    ref = P_inc.params_from_torch_state_dict(state_dict, device="cpu").state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())
    monkeypatch.delenv("PDDM_INCEPTION_WEIGHTS")
    model, stamp = P_inc.load_params(with_provenance=True, device="cpu")
    assert stamp == "random" and model.fc is not None
    assert isinstance(P_inc.load_params(device="cpu"), P_inc.FIDInceptionV3)
    # the random network is drawn from a generator: the same seed, the same
    # weights
    again = P_inc.random_params(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in model.state_dict().items())


def test_true_float32_restores_the_flags():
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = tuple(f.allow_tf32 for f in flags)
    try:
        for f in flags:
            f.allow_tf32 = True
        with pytest.raises(KeyError), P_inc.true_float32():
            assert not any(f.allow_tf32 for f in flags)
            raise KeyError
        assert all(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


# ------------------------------------------------------------- the scores


def test_activation_stats_and_frechet_distance_equal_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(300, 16).astype(np.float32), (rng.randn(200, 16) * 1.3 + 0.2)
    moments = []
    for Stats in (P_fid.ActivationStats, J_fid.ActivationStats):
        st = Stats()
        for i in range(0, 300, 64):
            st.update(a[i:i + 64])
        moments.append(st.finalize())
    for got, want in zip(*moments):
        np.testing.assert_array_equal(got, want)
    mu2, c2 = b.mean(0), np.cov(b, rowvar=False)
    assert P_fid.frechet_distance(*moments[0], mu2, c2) == \
        J_fid.frechet_distance(*moments[1], mu2, c2)
    # zero covariances (a zero root)
    z = np.zeros((4, 4))
    assert P_fid.frechet_distance(np.ones(4), z, np.zeros(4), z) == \
        J_fid.frechet_distance(np.ones(4), z, np.zeros(4), z)


@pytest.mark.parametrize("n_real,n_fake,subset", [(40, 30, 16), (12, 10, 1000)],
                         ids=["subsets", "one_subset"])
def test_kid_equals_jax(n_real, n_fake, subset):
    rng = np.random.RandomState(2)
    real = rng.randn(n_real, 32).astype(np.float32)
    fake = (rng.randn(n_fake, 32) * 1.1 + 0.1).astype(np.float32)
    got = P_kid.kernel_inception_distance(real, fake, subset_size=subset, n_subsets=7, seed=3)
    want = J_kid.kernel_inception_distance(real, fake, subset_size=subset, n_subsets=7, seed=3)
    assert got == want
    with pytest.raises(ValueError, match=">=2 rows"):
        P_kid.polynomial_mmd2(real[:1], fake)


def test_inception_score_equals_jax(state_dict, jax_inception):
    """From logits, and from pool features through the fc head of the same
    weights (the port's module against JAX's tree), in float64."""
    rng = np.random.RandomState(4)
    logits = rng.randn(50, 1008) * 3.0
    assert P_is.inception_score_from_logits(logits, splits=4) == \
        J_is.inception_score_from_logits(logits, splits=4)
    feats = np.abs(rng.randn(24, 2048)).astype(np.float32)
    model = P_inc.params_from_torch_state_dict(state_dict, device="cpu")
    assert P_is.inception_score_from_features(feats, model) == \
        J_is.inception_score_from_features(feats, jax_inception[0])
    with pytest.raises(ValueError, match="fc"):
        P_is.inception_score_from_features(feats, P_inc.FIDInceptionV3(fc=False))


def _pr_features():
    """Feature sets on which P&R is exact: no k-NN radius lies within 1e-4
    (relative) of a distance compared with it, checked here, so float32
    round-off in any framework or device cannot flip a decision."""
    rng = np.random.RandomState(5)
    real = rng.randn(64, 16).astype(np.float32)
    gen = (rng.randn(48, 16) * 0.8 + 0.3).astype(np.float32)

    def margins(x, y, k=3):
        d_xx = ((x[:, None] - x[None]) ** 2).sum(-1, dtype=np.float64)
        radius = np.sort(d_xx, axis=1)[:, k]
        d_yx = ((y[:, None] - x[None]) ** 2).sum(-1, dtype=np.float64)
        return np.abs(d_yx / radius[None] - 1.0).min()

    assert min(margins(real, gen), margins(gen, real)) >= 1e-4
    return real, gen


def test_precision_recall_equals_jax():
    real, gen = _pr_features()
    got = P_prd.knn_precision_recall(real, gen)
    want = J_prd.knn_precision_recall(real, gen)
    assert got == want and 0.0 < got["precision"] < 1.0 and 0.0 < got["recall"] < 1.0
    assert P_prd.knn_precision_recall(torch.from_numpy(real), torch.from_numpy(gen)) == got
    with pytest.raises(ValueError, match="more than k"):
        P_prd.knn_precision_recall(real[:3], gen)


# ------------------------------------------------------------- the pipeline

RES = 8


def _torch_feat(x01):
    x = torch.as_tensor(x01, dtype=torch.float32)
    b = x.shape[0]
    return torch.stack([x.mean((1, 2, 3)), x.reshape(b, -1).std(1), x.abs().mean((1, 2, 3)),
                        (x ** 2).mean((1, 2, 3)), x[..., 0].amax((1, 2))], 1)


def _jax_feat(x01):
    b = x01.shape[0]
    return jnp.stack([x01.mean((1, 2, 3)), x01.reshape(b, -1).std(1, ddof=1),
                      jnp.abs(x01).mean((1, 2, 3)), (x01 ** 2).mean((1, 2, 3)),
                      x01[..., 0].max((1, 2))], 1)


class StubEngine:
    """Fixed images in model space, a function of the seed alone."""

    device = torch.device("cpu")

    def generate_images(self, n, minibatch, mean_only, seed, num_sample_steps, ddim):
        rng = np.random.RandomState(100 + seed)
        return np.tanh(1.5 * rng.randn(n, RES, RES, 1)).astype(np.float32)


def _reals(n_batches=3):
    rng = np.random.RandomState(6)
    return [(rng.uniform(-1.0, 1.0, (8, RES, RES, 1)).astype(np.float32), None)
            for _ in range(n_batches)]


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


class SmallHead(torch.nn.Module):
    """Inception weights whose ``fc`` head reads the cheap features (5 wide),
    so the IS path runs without 2048-wide moments (a 2048 x 2048 ``sqrtm``
    takes tens of seconds on the CPU)."""

    def __init__(self, seed=7):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.fc = torch.nn.Module()
        self.fc.w = torch.from_numpy(rng.randn(5, 1008).astype(np.float32))
        self.fc.b = torch.from_numpy(0.1 * rng.randn(1008).astype(np.float32))

    def jax_tree(self):
        return {"fc": {"w": jnp.asarray(self.fc.w.numpy()), "b": jnp.asarray(self.fc.b.numpy())}}


@pytest.mark.parametrize("extras", [
    dict(),
    dict(with_precision_recall=True),
    dict(with_kid=True, with_inception_score=True),
], ids=["bare", "pr", "kid_is"])
def test_fid_from_engine_matches_jax(extras, monkeypatch):
    """Both pipelines on the same stub engine and reals, a cheap feature
    function patched into each: the bare call returns a float, an extra a
    dict with the stamp and the extras' coverage (``pr_limit`` rows a
    side; no real rows for IS alone)."""
    monkeypatch.setattr(P_fid, "_make_feature_fn", lambda p: _torch_feat)
    monkeypatch.setattr(J_fid, "_make_feature_fn", lambda p: _jax_feat)
    head = SmallHead()
    kw = dict(n_samples=20, minibatch=8, normalize="mnist", pr_limit=12, **extras)
    got = P_fid.compute_fid_from_engine(StubEngine(), _reals(), inception_params=head, **kw)
    want = J_fid.compute_fid_from_engine(StubEngine(), _reals(),
                                         inception_params=head.jax_tree(), **kw)
    _close(got, want)
    if not extras:
        assert isinstance(got, float)
        return
    assert got["inception_weights"] == "caller-provided" and got["extras_n_fake"] == 12
    assert ("extras_n_real" in got) == ("with_kid" in extras or "with_precision_recall" in
                                        extras)
    if "extras_n_real" in got:
        assert got["extras_n_real"] == 12
    with pytest.raises(ValueError, match="fc"):
        P_fid.compute_fid_from_engine(StubEngine(), _reals(), inception_params=torch.nn.Module(),
                                      with_inception_score=True)


def test_fid_for_loaders_matches_jax(monkeypatch):
    monkeypatch.setattr(P_fid, "_make_feature_fn", lambda p: _torch_feat)
    monkeypatch.setattr(J_fid, "_make_feature_fn", lambda p: _jax_feat)
    a, b = _reals(3), _reals(2)[::-1]
    got = P_fid.compute_fid_for_loaders(a, b, normalize="mnist", limit=20, inception_params={})
    want = J_fid.compute_fid_for_loaders(a, b, normalize="mnist", limit=20, inception_params={})
    _close(got, want)
    # the mesh statistics on a one-rank group: the one-process moments
    import torch.distributed as dist

    from probabilisticdeepdiffusionmodels_torch.parallel import make_mesh
    from probabilisticdeepdiffusionmodels_torch.parallel.runtime import free_port

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        batches = [b for b, _ in _reals(3)]
        mu, cov = P_fid.compute_statistics(batches, feature_fn=_torch_feat,
                                           mesh=make_mesh(1, device="cpu"))
    finally:
        dist.destroy_process_group()
    mu1, cov1 = P_fid.compute_statistics(batches, feature_fn=_torch_feat)
    np.testing.assert_allclose(mu, mu1, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cov, cov1, rtol=1e-10, atol=1e-12)


def test_inception_features_of_images_are_finite():
    """[0, 1] images of the CIFAR size through ``_make_feature_fn`` (resize,
    scale, forward) on the random network: 2048 finite features each."""
    feat = P_fid._make_feature_fn(P_inc.random_params(device="cpu"))
    out = feat(np.random.RandomState(8).rand(2, 32, 32, 3).astype(np.float32))
    assert out.shape == (2, 2048) and bool(torch.isfinite(out).all())


# ------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    return write_run(tmp_path_factory.mktemp("runs"), name="fid")


def _cheap_features(monkeypatch):
    """The cheap features, and a random network small enough to read them:
    ``load_params`` runs as it is, its ``random_params`` patched."""
    monkeypatch.setattr(P_fid, "_make_feature_fn", lambda p: _torch_feat)
    monkeypatch.setattr(P_inc, "random_params", lambda device=None: SmallHead())


@pytest.mark.parametrize("extras", [["true", "true", "true"], ["false"]],
                         ids=["pr_kid_is", "bare"])
def test_fid_score_cli(tiny_run, extras, monkeypatch, capsys):
    """JAX's positional argv (run, clip, n, steps, devices, pr, kid, is):
    the FID line, the stamp on every path, the extras' lines where asked,
    and the pipeline's seconds and img/s; ``device=cpu`` anywhere."""
    _cheap_features(monkeypatch)
    monkeypatch.delenv("PDDM_INCEPTION_WEIGHTS", raising=False)
    rc = cli_fid_score.main([tiny_run, "true", "8", "4", ""] + extras + CPU)
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    fid = float(next(line for line in out if line.startswith("FID:")).split()[1])
    assert np.isfinite(fid) and fid >= 0
    assert "inception_weights: random" in out
    assert any(line.startswith("FID pipeline:") and "sampled-img/s" in line for line in out)
    starts = {"precision:": extras[0] == "true", "KID:": len(extras) > 1,
              "IS:": len(extras) > 2}
    for start, wanted in starts.items():
        assert any(line.startswith(start) for line in out) == wanted, start
    if extras[0] == "true":
        line = next(line for line in out if line.startswith("precision:"))
        assert 0.0 <= float(line.split()[1]) <= 1.0 and 0.0 <= float(line.split()[3]) <= 1.0


def test_fid_score_cli_refuses(tiny_run, capsys):
    """No run directory; a devices value that is neither N nor DxM (a DxM
    mesh itself runs since item 21 is ported)."""
    assert cli_fid_score.main([]) == 1
    with pytest.raises(ValueError, match="DxM"):
        cli_fid_score.main([tiny_run, "true", "8", "4", "2xa"] + CPU)


def test_fid_debug_cli(monkeypatch, capsys):
    _cheap_features(monkeypatch)
    assert cli_fid_debug.main(TINY + CPU) == 0
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith("FID floor (train vs val):")
    assert np.isfinite(float(line.split()[-1]))
    with pytest.raises(ValueError, match="DxM"):
        cli_fid_debug.main(TINY + CPU + ["trainer.devices=2xa"])


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_card_inception_matches_cpu(card, state_dict):
    """The float32 forward on the card (TF32 off inside) against the same
    weights on the CPU, at batch 8, within 1e-4 relative; the card's resize
    against the CPU's."""
    x01 = np.random.RandomState(10).rand(8, 32, 32, 3).astype(np.float32)
    cpu = P_inc.params_from_torch_state_dict(state_dict, device="cpu")
    cuda = P_inc.params_from_torch_state_dict(state_dict, device="cuda")
    x = P_inc.preprocess(torch.from_numpy(x01))
    xc = P_inc.preprocess(torch.from_numpy(x01).cuda())
    assert float((xc.cpu() - x).abs().max()) <= 1e-5
    want = P_inc.inception_pool_features(cpu, x)
    got = P_inc.inception_pool_features(cuda, xc).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
def test_card_precision_recall_matches_cpu(card):
    real, gen = (torch.from_numpy(f) for f in _pr_features())
    assert P_prd.knn_precision_recall(real.cuda(), gen.cuda()) == \
        P_prd.knn_precision_recall(real, gen)

