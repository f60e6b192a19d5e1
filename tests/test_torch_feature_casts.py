"""The UNet's feature casts: made only where ``return_features`` asks.

A bf16 UNet fed float32 x used to cast every skip, the middle output and
every decoder output back to float32 on each forward, read or not (eager
torch runs a cast that nothing reads; JAX's ``jit`` drops it).  The
reference here is that earlier forward, written out with its casts: the
forward gives the same output bit for bit, ``return_features=True`` the same
dict, and a forward runs as many fewer ``aten._to_copy`` calls as it had
features: 33 at the CIFAR-10 UNet's layout (16 skips: the input conv's and
15 encoder entries', the middle block's, 16 decoder entries'), 9 at the
small test layout (4 skips: the input conv's, two res blocks' and a
downsample's; the middle's; 4 decoder entries', two res blocks a level).
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from probabilisticdeepdiffusionmodels_torch.models import get_model
from probabilisticdeepdiffusionmodels_torch.models.unet import _gn_silu_conv
from test_torch_threads import one_torch_thread  # noqa: E402,F401

# config/model/unet.yaml's layout (3 res blocks, mult 1-2-2-2, attention at
# 16 and 8, 4 heads) at a quarter of its width, so the CPU runs it quickly;
# the number of features does not depend on the width
CIFAR_LAYOUT = dict(name="unet", in_channels=3, model_channels=32, num_res_blocks=3,
                    attention_resolutions=[16, 8], channel_mult=[1, 2, 2, 2], num_heads=4,
                    compute_dtype="bfloat16")
SMALL = dict(name="unet", in_channels=3, model_channels=32, num_res_blocks=1,
             attention_resolutions=[4], channel_mult=[1, 2], num_heads=2,
             compute_dtype="bfloat16")


def _with_casts(model, x, t, return_features=False):
    """The forward as it was: every feature cast to x's dtype on each call."""
    emb = model._embed(t, None)
    in_dtype = x.dtype
    h = model.in_conv(x.to(model.dtype))
    hs = [h]
    for entry in model.encoder:
        h = model._run(h, entry, emb, None)
        hs.append(h)
    down = [s.to(in_dtype) for s in hs]
    h = model._run(h, model.middle, emb, None)
    middle = h.to(in_dtype)
    up = []
    for entry in model.decoder:
        h = model._run(torch.cat([h, hs.pop()], dim=-1), entry, emb, None)
        up.append(h.to(in_dtype))
    if return_features:
        return {"down": down, "middle": middle, "up": up}
    return _gn_silu_conv(h.to(in_dtype), model.out_norm, model.out_conv)


class _CountCasts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.casts = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._to_copy.default:
            self.casts += 1
        return func(*args, **(kwargs or {}))


def _model_and_inputs(cfg, resolution):
    model = get_model(resolution, cfg, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in model.parameters():  # the zero-init head and convs too
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    x = torch.randn(2, resolution, resolution, 3, generator=gen)
    t = torch.tensor([10, 500])
    return model, x, t


def _casts(fn):
    with torch.no_grad(), _CountCasts() as mode:
        out = fn()
    return out, mode.casts


def _check(cfg, resolution, features):
    model, x, t = _model_and_inputs(cfg, resolution)
    assert len(model.encoder) + 1 + 1 + len(model.decoder) == features
    out, casts = _casts(lambda: model(x, t))
    ref, ref_casts = _casts(lambda: _with_casts(model, x, t))
    assert out.dtype == torch.float32 and torch.equal(out, ref)
    assert ref_casts - casts == features
    got = model(x, t, return_features=True)
    want = _with_casts(model, x, t, return_features=True)
    assert got.keys() == want.keys()
    assert len(got["down"]) == len(want["down"]) and len(got["up"]) == len(want["up"])
    for a, b in zip([*got["down"], got["middle"], *got["up"]],
                    [*want["down"], want["middle"], *want["up"]]):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_cifar_layout_drops_33_casts_and_keeps_its_output():
    _check(CIFAR_LAYOUT, 32, 33)


def test_small_layout_drops_9_casts_and_keeps_its_output():
    _check(SMALL, 8, 9)
