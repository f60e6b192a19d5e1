"""Model factory, the counterpart of ``probabilisticdeepdiffusionmodels_tpu.models``.

``get_model(resolution, cfg)`` takes a config dict with a ``name`` key:
``"unet"`` (``dims`` 1, 2 or 3), ``"superres"`` (the 2-D UNet conditioned
on a low-res image, ``low_res``) or ``"dense"`` (the MLP baseline, float32;
``compute_dtype`` is dropped as JAX drops it).  ``attention_resolutions``
are image-side lengths, converted to downsample rates
(``resolution // res``).  ``learn_sigma`` doubles the output channels;
``cfg_null_class`` adds the null-class row; ``use_checkpoint`` recomputes
each block in the backward (``torch.utils.checkpoint``, JAX's remat).

The model is built on ``device``, which defaults to ``"cuda"``; with no CUDA
device that raises, so running on the CPU is an explicit request
(``device="cpu"``).  On the card the three hand-written kernels always run:
the ``use_pallas_attention``, ``pallas_attention_min_tokens``,
``use_pallas_gn`` and ``use_pallas_conv`` keys are accepted so the JAX
configs load, and have no effect.  ``dropout`` acts in train mode
(``model.train()``), where each ResBlock drops activations between its
second SiLU and conv, as the JAX model does; in eval mode, the mode
``get_model`` returns, it is the identity.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .dense import DenseModel
from .unet import SuperResModel, UNetModel

__all__ = ["get_model", "get_unet", "resolve_device", "UNetModel", "SuperResModel",
           "DenseModel"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def get_model(resolution: int, cfg: Dict[str, Any], *, device=None, seed: int = 0):
    cfg = dict(cfg)
    name = cfg.pop("name")
    if name == "unet":
        return get_unet(resolution, device=device, seed=seed, **cfg)
    if name == "superres":
        return get_unet(resolution, device=device, seed=seed, _cls=SuperResModel, **cfg)
    if name == "dense":
        device = resolve_device(device)
        cfg.setdefault("resolution", resolution)
        cfg.pop("compute_dtype", None)
        model = DenseModel(**cfg, generator=torch.Generator().manual_seed(seed))
        return model.to(device).eval()
    raise ValueError(f"Unknown model name: {name!r}")


def get_unet(
    resolution: int,
    in_channels: int,
    model_channels: int,
    num_res_blocks: int,
    attention_resolutions,
    dropout: float = 0,
    channel_mult=(1, 2, 4, 8),
    conv_resample: bool = True,
    dims: int = 2,
    num_classes=None,
    cfg_null_class: bool = False,
    use_checkpoint: bool = False,
    num_heads: int = 1,
    num_heads_upsample: int = -1,
    use_scale_shift_norm: bool = False,
    learn_sigma: bool = False,
    compute_dtype: str = "float32",
    use_pallas_attention: bool = False,
    pallas_attention_min_tokens: int = 256,
    use_pallas_gn: bool = False,
    use_pallas_conv: bool = False,
    *,
    device=None,
    seed: int = 0,
    _cls=UNetModel,
):
    """The UNet (``_cls``: or the SuperResModel around one) with weights
    drawn from ``seed``, in eval mode on ``device``; JAX's refusals."""
    device = resolve_device(device)
    if dims not in (1, 2, 3):
        raise ValueError(f"dims must be 1, 2 or 3, got {dims}")
    if cfg_null_class and not num_classes:
        raise ValueError("cfg_null_class requires num_classes (the null "
                         "token is the extra row of the label embedding)")
    if dims != 2 and _cls is SuperResModel:
        raise NotImplementedError("SuperResModel is 2-D (bilinear low_res)")
    attention_ds = tuple(resolution // int(res) for res in attention_resolutions)
    kwargs = {} if _cls is SuperResModel else {"dims": dims}
    model = _cls(
        in_channels=in_channels,
        model_channels=model_channels,
        out_channels=in_channels * (2 if learn_sigma else 1),
        num_res_blocks=num_res_blocks,
        attention_resolutions=attention_ds,
        channel_mult=tuple(channel_mult),
        conv_resample=conv_resample,
        num_classes=num_classes,
        cfg_null_class=cfg_null_class,
        num_heads=num_heads,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        dropout=dropout,
        dtype=_DTYPES[compute_dtype],
        generator=torch.Generator().manual_seed(seed),
        use_checkpoint=use_checkpoint,
        **kwargs,
    )
    return model.to(device).eval()
