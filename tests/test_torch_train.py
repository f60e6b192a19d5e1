"""The port's training slice against the JAX package.

Diffusion math, the loss history and timestep samplers, the optimizer chain,
the schedules and the EMA, each op's gradient, the dropout path of the
ResBlock, and one train step of a small UNet, all on the same numpy inputs
(and, for the step, the same t and noise, drawn from JAX's key stream and
injected into the port).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# The JAX train state needs Flax and optax; where they are missing (a machine
# set up for the card) the module skips, as test_torch_unet.py does.
pytest.importorskip("flax")
pytest.importorskip("optax")
import optax  # noqa: E402

from probabilisticdeepdiffusionmodels_tpu.core import (  # noqa: E402
    DiffusionTables as JaxTables,
    NoiseSchedule as JaxSchedule,
    diffusion as JD,
)
from probabilisticdeepdiffusionmodels_tpu.engine import (  # noqa: E402
    make_lr_schedule as jax_make_lr_schedule,
)
from probabilisticdeepdiffusionmodels_tpu.models import get_model as jax_get_model  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.ops import groupnorm_pallas  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.ops.attention import qkv_attention_xla  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.ops.gn_conv_pallas import (  # noqa: E402
    gn_silu_conv3x3 as jax_gn_silu_conv3x3,
)
from probabilisticdeepdiffusionmodels_tpu.train import samplers as JS  # noqa: E402
from probabilisticdeepdiffusionmodels_tpu.train.state import (  # noqa: E402
    TrainState as JaxTrainState,
    ema_update as jax_ema_update,
)
from probabilisticdeepdiffusionmodels_tpu.train.step import (  # noqa: E402
    make_train_step as jax_make_train_step,
)
from probabilisticdeepdiffusionmodels_torch.convert import (  # noqa: E402
    load_flax_params,
    params_from_flax,
)
from probabilisticdeepdiffusionmodels_torch.core import (  # noqa: E402
    DiffusionTables,
    NoiseSchedule,
    mean_flat,
    q_mean_std,
    q_sample,
)
from probabilisticdeepdiffusionmodels_torch.engine import (  # noqa: E402
    AdamChain,
    make_lr_schedule,
)
from probabilisticdeepdiffusionmodels_torch.models import get_model, unet  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.ops import gn_affine  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.ops.attention import _QkvAttention  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.ops.groupnorm import _GroupNormSilu  # noqa: E402
from probabilisticdeepdiffusionmodels_torch.ops.gn_conv import _GnSiluConv, _grad_reference  # noqa: E402,E501
from probabilisticdeepdiffusionmodels_torch.train import (  # noqa: E402
    LossHistory,
    TrainState,
    ema_update,
    importance_probs,
    importance_weights,
    make_eval_step,
    make_train_step,
    sample_importance,
)
from test_torch_unet import SMALL, _random_flax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- diffusion math


def test_q_sample_bit_equal_and_mean_flat():
    """Eager torch float32 ops round each product and sum once, as JAX's
    parity mode does: q_mean_std and q_sample are bit for bit.  mean_flat
    sums its 108 terms in another order than XLA: two float32 ulps."""
    rng = np.random.RandomState(0)
    x0 = rng.randn(4, 6, 6, 3).astype(np.float32)
    noise = rng.randn(4, 6, 6, 3).astype(np.float32)
    t = np.array([1, 17, 500, 1000], np.int32)
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(1000, "linear"), "cpu")
    with jax.enable_x64():
        jt = JaxTables.from_schedule(JaxSchedule.create(1000, "linear"))
        mean_j, std_j = JD.q_mean_std(jt, jnp.asarray(x0), jnp.asarray(t))
        xt_j = np.asarray(JD.q_sample(jt, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
        mf_j = np.asarray(JD.mean_flat(jnp.asarray(np.square(noise))))
    mean, std = q_mean_std(tables, _t(x0), _t(t).long())
    xt = q_sample(tables, _t(x0), _t(noise), _t(t).long())
    assert xt_j.dtype == np.float32
    np.testing.assert_array_equal(mean.numpy(), np.asarray(mean_j))
    np.testing.assert_array_equal(std.numpy(), np.asarray(std_j))
    np.testing.assert_array_equal(xt.numpy(), xt_j)
    mf = mean_flat(_t(np.square(noise))).numpy()
    assert mf.shape == (4,)
    np.testing.assert_allclose(mf, mf_j, rtol=2.4e-7, atol=0)


# ------------------------------------------------------------- loss history

# batches with repeated t, NaN and inf, a batch holding more same-t items
# than the ring (wrap inside one update) and a ring wrapped across updates
_HISTORY_T = 6


def _history_batches():
    rng = np.random.RandomState(3)
    out = []
    for b in range(5):
        t = rng.randint(1, _HISTORY_T + 1, size=9).astype(np.int32)
        loss = rng.rand(9).astype(np.float32)
        if b == 1:
            loss[[2, 5]] = [np.nan, np.inf]
        out.append((t, loss))
    t = np.full(13, 2, np.int32)
    t[[4, 9]] = 5
    loss = rng.rand(13).astype(np.float32)
    loss[[0, 7]] = [np.nan, -np.inf]
    out.append((t, loss))
    return out


def _both_histories():
    jh = JS.LossHistory.create(_HISTORY_T, 10)
    th = LossHistory(_HISTORY_T, 10)
    for t, loss in _history_batches():
        jh = jh.update(jnp.asarray(t), jnp.asarray(loss))
        th.update(_t(t), _t(loss))
    return jh, th


def test_loss_history_matches_jax():
    jh, th = _both_histories()
    np.testing.assert_array_equal(th.ring.numpy(), np.asarray(jh.ring))
    np.testing.assert_array_equal(th.ring_pos.numpy(), np.asarray(jh.ring_pos))
    np.testing.assert_array_equal(th.count.numpy(), np.asarray(jh.count))
    np.testing.assert_array_equal(th.epoch_count.numpy(), np.asarray(jh.epoch_count))
    assert int(th.count[1]) > 10  # t=2 wrapped its ring
    # sums and square roots in another order: 1e-6
    np.testing.assert_allclose(th.epoch_sum.numpy(), np.asarray(jh.epoch_sum), rtol=1e-6)
    np.testing.assert_allclose(th.avg_per_step_epoch().numpy(),
                               np.asarray(jh.avg_per_step_epoch()), rtol=1e-6)
    np.testing.assert_allclose(th.rms_per_step().numpy(), np.asarray(jh.rms_per_step()),
                               rtol=1e-6)
    np.testing.assert_allclose(importance_probs(th).numpy(),
                               np.asarray(JS.importance_probs(jh)), rtol=1e-6)
    for k in (1, 2, 3, 5):
        assert bool(th.is_warmed_up(k)) == bool(jh.is_warmed_up(k))
    th.reset_epoch()
    assert not th.epoch_sum.any() and not th.epoch_count.any() and th.count.any()


def test_importance_weights_and_draws():
    """Weights for given t are 1/(p[t-1] B) once warmed up and 1/B before;
    the draws follow p (chi-square-sized bound over 40000 draws)."""
    jh, th = _both_histories()
    t = np.array([1, 2, 2, 6], np.int32)
    p = np.asarray(JS.importance_probs(jh))
    w = importance_weights(th, _t(t).long(), min_counts=1).numpy()
    np.testing.assert_allclose(w, 1.0 / (p[t - 1] * 4), rtol=1e-6)
    w_cold = importance_weights(th, _t(t).long(), min_counts=10_000).numpy()
    np.testing.assert_array_equal(w_cold, np.full(4, 0.25, np.float32))

    gen = torch.Generator().manual_seed(0)
    t_draw, w_draw = sample_importance(gen, 40_000, th, min_counts=1)
    assert t_draw.min() >= 1 and t_draw.max() <= _HISTORY_T
    np.testing.assert_allclose(w_draw.numpy(), 1.0 / (p[t_draw.numpy() - 1] * 40_000),
                               rtol=1e-6)
    freq = np.bincount(t_draw.numpy() - 1, minlength=_HISTORY_T) / 40_000
    np.testing.assert_allclose(freq, p, atol=5 * np.sqrt(p * (1 - p) / 40_000).max())
    t_cold, w_cold = sample_importance(gen, 64, th, min_counts=10_000)
    assert torch.equal(w_cold, torch.full((64,), 1 / 64))
    assert t_cold.min() >= 1 and t_cold.max() <= _HISTORY_T


# ------------------------------------------------------------- optimizer


def _optax_chain(lr, grad_clip, k):
    tx = optax.adam(lr)
    if grad_clip:
        tx = optax.chain(optax.clip_by_global_norm(grad_clip), tx)
    if k > 1:
        tx = optax.MultiSteps(tx, k)
    return tx


@pytest.mark.parametrize("grad_clip,k", [(None, 1), (1.0, 2)])
def test_adam_chain_matches_optax(grad_clip, k):
    """Three updates on identical params and gradients, with a schedule
    (StepLR halving every update); gradients large and small, so the clip
    acts on some updates and not others.  Adam's rounding differs from
    optax's (torch's update is not written in the same order): 1e-6."""
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(scale * rng.randn(*s)).astype(np.float32) for s in shapes]
             for scale in (0.05, 3.0, 0.1, 2.0, 0.02, 1.0)[:3 * k]]
    kw = dict(step_size=1, gamma=0.5)
    tx = _optax_chain(jax_make_lr_schedule("StepLR", kw, 1e-2), grad_clip, k)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p.copy())) for p in params]
    chain = AdamChain(tp, make_lr_schedule("StepLR", kw, 1e-2), grad_clip=grad_clip,
                      accumulate_grad_batches=k)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = _t(x.copy())
        chain.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    assert chain.updates == 3
    assert not np.allclose(tp[0].detach().numpy(), params[0])


_SCHEDULES = [
    (None, None),
    ("CosineAnnealingWarmRestarts", dict(T_0=5, eta_min=1e-5)),
    ("CosineAnnealingWarmRestarts", dict(T_0=3, T_mult=2)),
    ("CosineAnnealing", dict(T_max=20, eta_min=0.1)),
    ("StepLR", dict(step_size=4, gamma=0.5)),
    ("ExponentialLR", dict(gamma=0.9)),
    ("MultiStepLR", dict(milestones=[10, 3], gamma=0.3)),
]


@pytest.mark.parametrize("steps_per_epoch", [None, 3])
@pytest.mark.parametrize("name,kw", _SCHEDULES, ids=[str(s[0]) for s in _SCHEDULES])
def test_lr_schedule_matches_jax(name, kw, steps_per_epoch):
    """JAX evaluates the schedule in float32, the port in float64: 1e-6."""
    ref = jax_make_lr_schedule(name, kw, 2e-4, steps_per_epoch=steps_per_epoch)
    sched = make_lr_schedule(name, kw, 2e-4, steps_per_epoch=steps_per_epoch)
    if name is None:
        assert sched == ref == 2e-4
        return
    want = [float(ref(jnp.asarray(s))) for s in range(80)]
    got = [sched(s) for s in range(80)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 2e-4)
    assert len(set(np.round(got, 12))) > 1


@pytest.mark.parametrize("decay", [0.999, 0.9999])
def test_ema_update_bit_equal(decay):
    rng = np.random.RandomState(1)
    ema = {"a": rng.randn(7, 3).astype(np.float32), "b": rng.randn(11).astype(np.float32)}
    par = {k: rng.randn(*v.shape).astype(np.float32) for k, v in ema.items()}
    ref = jax_ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                         {k: jnp.asarray(v) for k, v in par.items()}, decay)
    got = [_t(ema[k].copy()) for k in ema]
    ema_update(got, [_t(par[k]) for k in ema], decay)
    for k, g in zip(ema, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(ref[k]))


# ------------------------------------------------------------- op backward


def _grads_close(got, want, what):
    """Each gradient within 1e-5 of its largest element (float32 sums in
    another order on both sides of the comparison)."""
    for name, g, w in zip(what, got, want):
        w = np.asarray(w)
        assert g is not None, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("function", ["kernel_function", "gn_silu_conv"])
@pytest.mark.parametrize("mode", ["emb", "film"])
def test_gn_conv_backward_matches_jax(mode, function):
    """The conv's gradient (gn_affine in torch autograd in front of it)
    against ``jax.vjp`` of the custom-VJP op, whose forward is the
    interpret-mode Pallas kernel: ``kernel_function``, the recompute that
    the backward's ``recompute`` design runs (autograd through
    ``_grad_reference``), and the op's own Function with the plain version
    standing in for the kernel, whose backward is ``gn_silu_conv3x3_grad``
    (its plain version on the CPU)."""
    rng = np.random.RandomState(5)
    c = 128  # the Pallas path needs channels % 128 == 0
    x = rng.randn(2, 4, 4, c).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    w = (rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32)  # HWIO
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    cond = [rng.randn(2, c).astype(np.float32) for _ in range(1 if mode == "emb" else 2)]
    g = rng.randn(2, 4, 4, c).astype(np.float32)

    def jax_op(x, gamma, beta, w, bias, *cond):
        extra = dict(emb=cond[0]) if mode == "emb" else dict(film=tuple(cond))
        return jax_gn_silu_conv3x3(x, gamma, beta, w, bias, num_groups=32,
                                   interpret=True, **extra)

    args = [x, gamma, beta, w, bias, *cond]
    _, vjp = jax.vjp(jax_op, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))

    leaves = [_t(a.copy()).requires_grad_(True) for a in args]
    tx, tgamma, tbeta, tw, tbias, *tcond = leaves
    extra = dict(emb=tcond[0]) if mode == "emb" else dict(film=tuple(tcond))
    a, off = gn_affine(tx, tgamma, tbeta, 32, 1e-5, **extra)
    w_hwoi = tw.permute(0, 1, 3, 2)
    if function == "kernel_function":
        out = _grad_reference(tx, a, off, w_hwoi, tbias)
    else:
        out = _GnSiluConv.apply(tx, a, off, w_hwoi, tbias)
    assert out.grad_fn is not None
    out.backward(_t(g))
    _grads_close([p.grad.numpy() for p in leaves], want,
                 ["x", "gamma", "beta", "w", "bias"] + [f"cond{i}" for i in range(len(cond))])


@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_backward_matches_jax(silu, monkeypatch):
    """The op's Function (the plain versions standing in for the kernels:
    its backward is ``group_norm_silu_grad_plain``) against ``jax.vjp`` of
    ``group_norm_silu`` (custom VJP, forward the interpret-mode Pallas
    kernel as tests/test_pallas_ops.py runs it)."""
    orig = groupnorm_pallas.group_norm_silu_pallas
    monkeypatch.setattr(groupnorm_pallas, "group_norm_silu_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    rng = np.random.RandomState(6)
    x = (rng.randn(2, 8, 8, 64) + 0.5).astype(np.float32)
    gamma = rng.randn(64).astype(np.float32)
    beta = rng.randn(64).astype(np.float32)
    g = rng.randn(2, 8, 8, 64).astype(np.float32)
    _, vjp = jax.vjp(lambda x, gm, bt: groupnorm_pallas.group_norm_silu(x, gm, bt, 32, 1e-5, silu),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jnp.asarray(g))
    leaves = [_t(a.copy()).requires_grad_(True) for a in (x, gamma, beta)]
    _GroupNormSilu.apply(*leaves, 32, 1e-5, silu).backward(_t(g))
    _grads_close([p.grad.numpy() for p in leaves], want, ["x", "gamma", "beta"])


@pytest.mark.parametrize("num_heads", [1, 4])
def test_attention_backward_matches_jax(num_heads):
    rng = np.random.RandomState(7)
    qkv = rng.randn(2, 16, 3 * 64).astype(np.float32)
    g = rng.randn(2, 16, 64).astype(np.float32)
    _, vjp = jax.vjp(lambda q: qkv_attention_xla(q, num_heads), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    leaf = _t(qkv.copy()).requires_grad_(True)
    # the op's Function, the plain versions standing in for the kernels
    _QkvAttention.apply(leaf, num_heads).backward(_t(g))
    _grads_close([leaf.grad.numpy()], [want], ["qkv"])


def test_function_returns_grads_in_each_input_dtype():
    """bf16 activations with float32 scale/offset: each gradient in its
    input's dtype, and none for an input that does not need one."""
    x = torch.randn(1, 4, 4, 32).bfloat16().requires_grad_(True)
    a = torch.rand(1, 32).requires_grad_(True)
    off = torch.randn(1, 32)
    w = torch.randn(3, 3, 8, 32).bfloat16().requires_grad_(True)
    bias = torch.zeros(8, requires_grad=True)
    out = _GnSiluConv.apply(x, a, off, w, bias)
    out.float().sum().backward()
    assert (x.grad.dtype, a.grad.dtype, w.grad.dtype, bias.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16, torch.float32)
    assert off.grad is None


# ------------------------------------------------------------- dropout


def _small_model(dropout, seed=0):
    """A small UNet with its zero-init parameters (the output head, every
    ResBlock's second conv) filled, so each branch reaches the output."""
    model = get_model(8, dict(SMALL, dropout=dropout), device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def test_dropout_zero_in_train_mode_equals_eval():
    model = _small_model(0.0)
    x, t = torch.randn(2, 8, 8, 3), torch.tensor([3, 700])
    with torch.no_grad():
        ref = model.eval()(x, t)
        out = model.train()(x, t)
    assert torch.equal(out, ref)


def test_dropout_takes_the_unfused_path(monkeypatch):
    """In train mode with p > 0 each ResBlock's second conv leaves the fused
    op and the dropout zeroes about p of its input, with the mask drawn from
    the generator passed to the forward; with the dropout made the identity,
    the unfused path computes what the fused one does (float32 sums in
    another order: 1e-5)."""
    model = _small_model(0.3)
    x, t = torch.randn(2, 8, 8, 3), torch.tensor([3, 700])
    n_res = sum(isinstance(m, unet.ResBlock) for m in model.modules())
    fused_calls, dropped = [], []
    real_fused, real_mask, real_masked = unet.gn_silu_conv3x3, unet.dropout_mask, unet.masked
    gen = torch.Generator().manual_seed(11)

    def count_fused(*a):
        fused_calls.append(1)
        return real_fused(*a)

    monkeypatch.setattr(unet, "gn_silu_conv3x3", count_fused)
    with torch.no_grad():
        ref = model.eval()(x, t)
        assert len(fused_calls) == 2 * n_res + 1
        fused_calls.clear()
        monkeypatch.setattr(unet, "masked", lambda y, keep, p: y)
        same = model.train()(x, t, generator=gen)
        assert len(fused_calls) == n_res + 1
        torch.testing.assert_close(same, ref, rtol=1e-5, atol=1e-5)

        def draw(shape, p, g, device):
            assert g is gen
            return real_mask(shape, p, g, device)

        def record(y, keep, p):
            out = real_masked(y, keep, p)
            dropped.append((y, out))
            return out

        monkeypatch.setattr(unet, "dropout_mask", draw)
        monkeypatch.setattr(unet, "masked", record)
        noisy = model(x, t, generator=gen)
    assert len(dropped) == n_res and not torch.equal(noisy, ref)
    zeros = sum(int((out == 0).sum()) for _, out in dropped)
    total = sum(out.numel() for _, out in dropped)
    assert abs(zeros / total - 0.3) < 0.02
    y, out = dropped[0]
    kept = out != 0
    torch.testing.assert_close(out[kept], y[kept] / 0.7)
    monkeypatch.setattr(unet, "dropout_mask", real_mask)
    with pytest.raises(ValueError, match="generator"):
        model(x, t)


def test_dropout_masks_come_from_the_state_generator():
    """Two train steps from states seeded alike give the same loss with
    dropout > 0, a third seed another, and torch's default generator is
    left untouched."""
    T = 1000
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(T, "linear"), "cpu")
    step = make_train_step(tables)
    x0 = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))

    def loss(seed):
        model = _small_model(0.3)
        state = TrainState(model, AdamChain(model.parameters(), 2e-4), T,
                           torch.Generator().manual_seed(seed))
        return float(step(state, x0, t=torch.tensor([500, 500]),
                          noise=torch.zeros_like(x0))["loss"])

    before = torch.get_rng_state()
    first, again, other = loss(1), loss(1), loss(2)
    assert torch.equal(torch.get_rng_state(), before)
    assert first == again and first != other


# ------------------------------------------------------------- train step


def _jax_setup(cfg, x0, T, tables_kw, sampling, seed, min_counts=10):
    jm = jax_get_model(8, cfg)
    params = _random_flax_params(jm, jnp.asarray(x0), jnp.ones((x0.shape[0],), jnp.int32),
                                 seed=seed)

    def apply_fn(params, x, t, y=None, **kwargs):
        return jm.apply({"params": params}, x, t, y)

    jt = JaxTables.from_schedule(JaxSchedule.create(T, "linear", **tables_kw))
    state = JaxTrainState.create(params, optax.adam(2e-4), T, jax.random.PRNGKey(seed),
                                 ema_decay=0.999)
    step = jax.jit(jax_make_train_step(apply_fn, jt, sampling=sampling,
                                       min_counts=min_counts))
    return params, state, step


def _jax_draws(state, b, T, shape, sampling, min_counts):
    """JAX's t and noise of the next step: fold_in(rng, step) -> split 3."""
    rng = jax.random.fold_in(state.rng, state.step)
    key_t, key_noise, _ = jax.random.split(rng, 3)
    if sampling == "importance":
        t, _ = JS.sample_importance(key_t, b, state.loss_history, min_counts)
    else:
        t, _ = JS.sample_uniform(key_t, b, T)
    noise = jax.random.normal(key_noise, shape, jnp.float32)
    return np.asarray(t), np.asarray(noise)


def _port_setup(cfg, params, T, tables_kw, seed):
    model = load_flax_params(get_model(8, cfg, device="cpu"), params)
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(T, "linear", **tables_kw),
                                           "cpu")
    state = TrainState(model, AdamChain(model.parameters(), 2e-4), T,
                       torch.Generator().manual_seed(seed), ema_decay=0.999)
    return tables, state


def _adam_first_grads(jstate):
    """optax's first Adam moment after one update is (1 - b1) * g."""
    mu = jstate.opt_state[0].mu
    return jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), mu)


def test_train_step_matches_jax():
    """One float32 step of a small UNet (C=64, so GroupNorm's 32 groups do
    not normalise the emb add away) with Flax weights in both frameworks and
    JAX's t and noise injected.  Loss 1e-5 and grad_norm 1e-4 relative; each
    gradient within 1e-4 of its largest element.  Adam's first update is
    about lr * sign(g), so a round-off difference in a near-zero gradient
    can move a parameter by up to 2 * lr: params and EMA after the step are
    held to 2 * lr (the optimizer itself is held to 1e-6 on identical
    gradients in test_adam_chain_matches_optax)."""
    cfg, T = dict(SMALL), 1000
    x0 = np.random.RandomState(11).randn(4, 8, 8, 3).astype(np.float32)
    params, jstate, jstep = _jax_setup(cfg, x0, T, {}, "uniform", seed=11)
    t, noise = _jax_draws(jstate, 4, T, x0.shape, "uniform", 10)
    jstate, jmetrics = jstep(jstate, jnp.asarray(x0))

    tables, state = _port_setup(cfg, params, T, {}, seed=11)
    metrics = make_train_step(tables)(state, _t(x0), t=_t(t).long(), noise=_t(noise))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    want = params_from_flax(_adam_first_grads(jstate))
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    for k, w in want.items():
        np.testing.assert_allclose(named[k].grad.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()), err_msg=k)
    for mine, ref in ((state.model, jstate.params), (state.ema_model, jstate.ema_params)):
        got = mine.state_dict()
        for k, w in params_from_flax(jax.tree.map(np.asarray, ref)).items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2 * 2e-4,
                                       err_msg=k)
    assert state.step == 1 and state.model.training
    assert int(state.loss_history.count.sum()) == 4


def test_train_step_importance_matches_jax():
    """T=10 (linear betas 1e-4..0.2, since the 1000/T scaling of the default
    ends above 1) and min_counts=1, so the history warms up within a few
    steps: the count and ring position stay equal to JAX's exactly, the
    ring's losses to 1e-5, and each step's loss to 1e-4 (after the first
    update the parameters differ by Adam's round-off, above)."""
    cfg, T, kw = dict(SMALL, use_scale_shift_norm=True), 10, dict(beta_start=1e-4,
                                                                    beta_end=0.2)
    x0 = np.random.RandomState(12).randn(4, 8, 8, 3).astype(np.float32)
    params, jstate, jstep = _jax_setup(cfg, x0, T, kw, "importance", seed=12, min_counts=1)
    tables, state = _port_setup(cfg, params, T, kw, seed=12)
    step = make_train_step(tables, sampling="importance", min_counts=1)
    warm = 0
    for _ in range(12):
        t, noise = _jax_draws(jstate, 4, T, x0.shape, "importance", 1)
        jstate, jmetrics = jstep(jstate, jnp.asarray(x0))
        metrics = step(state, _t(x0), t=_t(t).long(), noise=_t(noise))
        jh, th = jstate.loss_history, state.loss_history
        np.testing.assert_array_equal(th.count.numpy(), np.asarray(jh.count))
        np.testing.assert_array_equal(th.ring_pos.numpy(), np.asarray(jh.ring_pos))
        np.testing.assert_allclose(th.ring.numpy(), np.asarray(jh.ring), rtol=1e-5, atol=0)
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4)
        warm += bool(th.is_warmed_up(1))
        if warm == 2:
            break
    assert warm == 2, "the history did not warm up"


def test_eval_step_and_option_checks():
    cfg = dict(SMALL)
    tables = DiffusionTables.from_schedule(NoiseSchedule.create(1000, "linear"), "cpu")
    model = get_model(8, cfg, device="cpu").train()
    x0 = torch.randn(2, 8, 8, 3)
    t, noise = torch.tensor([5, 900]), torch.randn(2, 8, 8, 3)
    loss = make_eval_step(tables)(model, torch.Generator(), x0, t=t, noise=noise)
    assert not model.training
    with torch.no_grad():
        want = mean_flat((noise - model(q_sample(tables, x0, noise, t), t)) ** 2).mean()
    assert torch.equal(loss, want)
    # the item-11 objectives build (test_torch_objectives.py holds each
    # against JAX); what no objective means is refused
    for kw in (dict(loss_type="hybrid"), dict(prediction_type="v"),
               dict(prediction_type="x0"), dict(loss_weighting="min_snr"),
               dict(class_dropout_prob=0.1, null_class=10)):
        assert callable(make_train_step(tables, **kw))
    for kw, match in ((dict(sampling="stratified"), "sampling"),
                      (dict(loss_type="kl"), "loss_type"),
                      (dict(prediction_type="edm"), "prediction_type"),
                      (dict(loss_weighting="p2"), "loss_weighting"),
                      (dict(class_dropout_prob=0.1), "null_class")):
        with pytest.raises(ValueError, match=match):
            make_train_step(tables, **kw)
    with pytest.raises(ValueError, match="prediction_type"):
        make_eval_step(tables, prediction_type="edm")
