"""InceptionV3, the FID variant, as an inference ``nn.Module``.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/evals/inception.py``:
pytorch-fid's InceptionV3 feature extractor (torchvision's graph with its
three patches to match the TF model: the A, C and E blocks' average pools
with ``count_include_pad=False``, and a MAX pool in the last E block,
Mixed_7c), so ported weights give pytorch-fid's activations.

The module takes [-1, 1] NHWC images of 299x299 and works in NCHW inside.
BatchNorm is folded at load time into a per-channel scale and shift; each
conv's weight is OIHW.  Its ``state_dict`` keys are the JAX param tree's
paths (``Mixed_5b.branch1x1.w``, ``fc.w``, ...).  The convolutions run
``F.conv2d``: JAX computes them with ``lax.conv_general_dilated``, outside
any Pallas kernel.  The forward runs in true float32 (``true_float32``: no
TF32 in cuDNN or cuBLAS), restoring the caller's flags after.

Weights: ``PDDM_INCEPTION_WEIGHTS`` (or ``load_params(weights_path)``)
names pytorch-fid's ``pt_inception-2015-12-05-6726825d.pth``; the stamp
``"ported:<md5>"`` says so.  Without it, ``random_params`` builds a random
network stamped ``"random"``: the FID pipeline runs, but its numbers are not
comparable to pytorch-fid's (nor to the JAX package's random network, which
draws other numbers).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import resolve_device

__all__ = [
    "FIDInceptionV3",
    "inception_pool_features",
    "inception_logits",
    "params_from_torch_state_dict",
    "random_params",
    "load_params",
    "preprocess",
    "true_float32",
    "FEATURE_DIM",
    "NUM_CLASSES",
]

FEATURE_DIM = 2048
NUM_CLASSES = 1008  # the TF-ported fc head of the pytorch-fid checkpoint
_BN_EPS = 0.001


@contextlib.contextmanager
def true_float32():
    """float32 convolutions and products without TF32 inside; the caller's
    flags restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------- layers


class _Conv(torch.nn.Module):
    """BasicConv2d: conv (no bias), folded BN, relu."""

    def __init__(self, cin, cout, kh, kw, stride=1, padding=(0, 0)):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.register_buffer("w", torch.zeros(cout, cin, kh, kw))
        self.register_buffer("scale", torch.ones(cout))
        self.register_buffer("shift", torch.zeros(cout))

    def forward(self, x):
        y = F.conv2d(x, self.w, stride=self.stride, padding=self.padding)
        return torch.relu(y * self.scale[:, None, None] + self.shift[:, None, None])


def _avg3_nip(x):
    """3x3 stride-1 average pool, pad 1, count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class _BlockA(torch.nn.Module):
    def __init__(self, cin, pool_feat):
        super().__init__()
        self.branch1x1 = _Conv(cin, 64, 1, 1)
        self.branch5x5_1 = _Conv(cin, 48, 1, 1)
        self.branch5x5_2 = _Conv(48, 64, 5, 5, padding=(2, 2))
        self.branch3x3dbl_1 = _Conv(cin, 64, 1, 1)
        self.branch3x3dbl_2 = _Conv(64, 96, 3, 3, padding=(1, 1))
        self.branch3x3dbl_3 = _Conv(96, 96, 3, 3, padding=(1, 1))
        self.branch_pool = _Conv(cin, pool_feat, 1, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg3_nip(x))], 1)


class _BlockB(torch.nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = _Conv(cin, 384, 3, 3, stride=2)
        self.branch3x3dbl_1 = _Conv(cin, 64, 1, 1)
        self.branch3x3dbl_2 = _Conv(64, 96, 3, 3, padding=(1, 1))
        self.branch3x3dbl_3 = _Conv(96, 96, 3, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max3s2(x)], 1)


class _BlockC(torch.nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = _Conv(cin, 192, 1, 1)
        self.branch7x7_1 = _Conv(cin, c7, 1, 1)
        self.branch7x7_2 = _Conv(c7, c7, 1, 7, padding=(0, 3))
        self.branch7x7_3 = _Conv(c7, 192, 7, 1, padding=(3, 0))
        self.branch7x7dbl_1 = _Conv(cin, c7, 1, 1)
        self.branch7x7dbl_2 = _Conv(c7, c7, 7, 1, padding=(3, 0))
        self.branch7x7dbl_3 = _Conv(c7, c7, 1, 7, padding=(0, 3))
        self.branch7x7dbl_4 = _Conv(c7, c7, 7, 1, padding=(3, 0))
        self.branch7x7dbl_5 = _Conv(c7, 192, 1, 7, padding=(0, 3))
        self.branch_pool = _Conv(cin, 192, 1, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg3_nip(x))], 1)


class _BlockD(torch.nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = _Conv(cin, 192, 1, 1)
        self.branch3x3_2 = _Conv(192, 320, 3, 3, stride=2)
        self.branch7x7x3_1 = _Conv(cin, 192, 1, 1)
        self.branch7x7x3_2 = _Conv(192, 192, 1, 7, padding=(0, 3))
        self.branch7x7x3_3 = _Conv(192, 192, 7, 1, padding=(3, 0))
        self.branch7x7x3_4 = _Conv(192, 192, 3, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for conv in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max3s2(x)], 1)


class _BlockE(torch.nn.Module):
    def __init__(self, cin, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = _Conv(cin, 320, 1, 1)
        self.branch3x3_1 = _Conv(cin, 384, 1, 1)
        self.branch3x3_2a = _Conv(384, 384, 1, 3, padding=(0, 1))
        self.branch3x3_2b = _Conv(384, 384, 3, 1, padding=(1, 0))
        self.branch3x3dbl_1 = _Conv(cin, 448, 1, 1)
        self.branch3x3dbl_2 = _Conv(448, 384, 3, 3, padding=(1, 1))
        self.branch3x3dbl_3a = _Conv(384, 384, 1, 3, padding=(0, 1))
        self.branch3x3dbl_3b = _Conv(384, 384, 3, 1, padding=(1, 0))
        self.branch_pool = _Conv(cin, 192, 1, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        # the pytorch-fid patch: Mixed_7c pools by MAX
        pooled = _avg3_nip(x) if self.pool == "avg" else F.max_pool2d(x, 3, stride=1,
                                                                       padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class _Head(torch.nn.Module):
    """The fc classifier, stored [in, out] as the JAX tree stores it."""

    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.zeros(FEATURE_DIM, NUM_CLASSES))
        self.register_buffer("b", torch.zeros(NUM_CLASSES))


class FIDInceptionV3(torch.nn.Module):
    """[B, 299, 299, 3] in [-1, 1] -> [B, 2048] pool features; ``fc`` is the
    classifier head (None where the weights carry none)."""

    def __init__(self, fc: bool = True):
        super().__init__()
        self.Conv2d_1a_3x3 = _Conv(3, 32, 3, 3, stride=2)
        self.Conv2d_2a_3x3 = _Conv(32, 32, 3, 3)
        self.Conv2d_2b_3x3 = _Conv(32, 64, 3, 3, padding=(1, 1))
        self.Conv2d_3b_1x1 = _Conv(64, 80, 1, 1)
        self.Conv2d_4a_3x3 = _Conv(80, 192, 3, 3)
        self.Mixed_5b = _BlockA(192, 32)
        self.Mixed_5c = _BlockA(256, 64)
        self.Mixed_5d = _BlockA(288, 64)
        self.Mixed_6a = _BlockB(288)
        self.Mixed_6b = _BlockC(768, 128)
        self.Mixed_6c = _BlockC(768, 160)
        self.Mixed_6d = _BlockC(768, 160)
        self.Mixed_6e = _BlockC(768, 192)
        self.Mixed_7a = _BlockD(768)
        self.Mixed_7b = _BlockE(1280, "avg")
        self.Mixed_7c = _BlockE(2048, "max")
        self.fc = _Head() if fc else None
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous()
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max3s2(x)
        x = _max3s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return torch.mean(x, dim=(2, 3))


def _device_of(params: torch.nn.Module) -> torch.device:
    return next(params.buffers()).device


def inception_pool_features(params: FIDInceptionV3, x: torch.Tensor) -> torch.Tensor:
    """x: [B, 299, 299, 3] in [-1, 1] (moved to the module's device) ->
    [B, 2048] float32 pool features, in true float32."""
    with torch.no_grad(), true_float32():
        return params(torch.as_tensor(x, dtype=torch.float32, device=_device_of(params)))


def inception_logits(params: FIDInceptionV3, x: torch.Tensor) -> torch.Tensor:
    """x: [B, 299, 299, 3] in [-1, 1] -> [B, 1008] class logits through
    the fc head (which the Inception Score reads)."""
    if params.fc is None:
        raise ValueError("the Inception weights carry no 'fc' classifier head")
    feats = inception_pool_features(params, x)
    with torch.no_grad(), true_float32():
        return feats @ params.fc.w + params.fc.b


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC images of any size -> 299x299 in [-1, 1] (pytorch-fid's
    resize_input and normalize_input); a grey image fills 3 channels.

    JAX resizes with ``jax.image.resize(..., "bilinear")``: half-pixel
    centres, the kernel renormalised where it leaves the image, and an
    antialiasing (widened) kernel when shrinking.  ``F.interpolate``'s
    bilinear mode without ``align_corners`` clamps at the edges, which
    gives the same weights when growing; when shrinking it antialiases."""
    x = torch.as_tensor(x, dtype=torch.float32)
    h, w = x.shape[1], x.shape[2]
    if (h, w) != (299, 299):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=h > 299 or w > 299)
        x = x.permute(0, 2, 3, 1)
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    return 2.0 * x - 1.0


# ---------------------------------------------------------------- weights


def _convs(module: torch.nn.Module):
    """(path, _Conv) of every conv, in the module's order."""
    return [(name, m) for name, m in module.named_modules() if isinstance(m, _Conv)]


def params_from_torch_state_dict(sd, device="cpu") -> FIDInceptionV3:
    """The module of a pytorch-fid InceptionV3 ``state_dict``: BatchNorm
    folded in numpy float32 as JAX folds it, scale = gamma / sqrt(var +
    eps), shift = beta - mean * scale; conv weights stay OIHW; the torch
    Linear ``fc`` ([out, in]) stored [in, out]."""
    model = FIDInceptionV3(fc="fc.weight" in sd)
    for name, conv in _convs(model):
        gamma = sd[f"{name}.bn.weight"].numpy()
        beta = sd[f"{name}.bn.bias"].numpy()
        mean = sd[f"{name}.bn.running_mean"].numpy()
        var = sd[f"{name}.bn.running_var"].numpy()
        scale = gamma / np.sqrt(var + _BN_EPS)
        shift = beta - mean * scale
        conv.w.copy_(sd[f"{name}.conv.weight"])
        conv.scale.copy_(torch.from_numpy(np.asarray(scale, np.float32)))
        conv.shift.copy_(torch.from_numpy(np.asarray(shift, np.float32)))
    if model.fc is not None:
        model.fc.w.copy_(sd["fc.weight"].T)
        model.fc.b.copy_(sd["fc.bias"])
    return model.to(device)


def random_params(generator: Optional[torch.Generator] = None, device=None) -> FIDInceptionV3:
    """A random network with the right shapes, for running the pipeline
    without the pytorch-fid checkpoint: each conv's weight N(0, 1 / fan_in),
    scale 1 and shift 0, the fc head N(0, 1 / 2048) with bias 0, drawn on
    the host from ``generator`` (default: seeded 0).  The numbers differ from
    the JAX package's random network, which draws from a JAX key."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    model = FIDInceptionV3()
    for _, conv in _convs(model):
        cout, cin, kh, kw = conv.w.shape
        conv.w.copy_(torch.randn(conv.w.shape, generator=gen) / math.sqrt(cin * kh * kw))
    model.fc.w.copy_(torch.randn(model.fc.w.shape, generator=gen) / math.sqrt(FEATURE_DIM))
    return model.to(resolve_device(device))


def load_params(weights_path: Optional[str] = None, with_provenance: bool = False,
                device=None):
    """The ported pytorch-fid weights (``weights_path`` or
    ``PDDM_INCEPTION_WEIGHTS``), or random ones with a warning, on
    ``device`` (None: cuda).  ``with_provenance=True`` returns (module,
    stamp), the stamp ``"ported:<md5 of the file>"`` or ``"random"``: every
    FID, KID and IS result carries it, so a random network's number is never
    taken for a pytorch-fid one."""
    path = weights_path or os.environ.get("PDDM_INCEPTION_WEIGHTS")
    if path and os.path.exists(path):
        import hashlib

        h = hashlib.md5()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        params = params_from_torch_state_dict(sd, device=resolve_device(device))
        return (params, f"ported:{h.hexdigest()}") if with_provenance else params
    print("[fid] WARNING: no InceptionV3 checkpoint found (set PDDM_INCEPTION_WEIGHTS); using "
          "RANDOM weights — FID values will not be comparable to pytorch-fid.")
    params = random_params(device=device)
    return (params, "random") if with_provenance else params

