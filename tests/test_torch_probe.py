"""The port's matrix-unit probe against ``scripts/probe_mosaic_bf16.py``.

The plain version is held against the JAX script's own ``_kernel``, run
through ``pl.pallas_call(..., interpret=True)`` on the CPU; the script is
loaded by file path and left as it is.  The ``gpu`` test holds the CUDA
kernel against the plain version on the card.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from probabilisticdeepdiffusionmodels_torch.ops import probe_mma as P
from test_torch_threads import one_torch_thread  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
_DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _jax_probe_module():
    path = REPO / "scripts" / "probe_mosaic_bf16.py"
    spec = importlib.util.spec_from_file_location("probe_mosaic_bf16", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_probe_plain_matches_interpret_pallas(dtype):
    """Seeded random operands (bf16 ones rounded before both products);
    float32 sums of 256 products in another order: 1e-4 of the output
    scale."""
    tdt, jdt = _DTYPES[dtype]
    a, b = P.random_operands(tdt, "cpu", seed=3)
    kernel = _jax_probe_module()._kernel
    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((256, 256), jnp.float32),
                          interpret=True)
    ref = np.asarray(call(jnp.asarray(a.float().numpy(), jdt),
                          jnp.asarray(b.float().numpy(), jdt)))
    out = P.try_dtype(tdt, a, b, device="cpu")
    assert out.dtype == torch.float32 and out.shape == (256, 256)
    scale = np.abs(ref).max()
    assert scale > 10  # random operands: no product of ones
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=P.TOL * scale)


def test_probe_defaults_and_rules():
    P.probe_mma.launches = 0
    out = P.try_dtype(torch.bfloat16, device="cpu")
    a, b = P.random_operands(torch.bfloat16, "cpu")
    assert torch.equal(out, a.float() @ b.float())
    assert len(torch.unique(a)) > 1000
    assert P.probe_mma.launches == 0  # the CPU takes the plain version
    with pytest.raises(ValueError, match="256x256"):
        P.probe_mma(torch.zeros(128, 256), torch.zeros(256, 256))
    with pytest.raises(ValueError, match="float32 or two bfloat16"):
        P.probe_mma(torch.zeros(256, 256), torch.zeros(256, 256, dtype=torch.float64))


def test_probe_main_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot occur")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        P.try_dtype(torch.float32)


@pytest.fixture
def card():
    """A test on the card: skipped without one; the plain version's matmul
    in true float32 (TF32 off), the flag restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_card_probe_kernel_matches_plain(dtype, card):
    tdt, _ = _DTYPES[dtype]
    a, b = P.random_operands(tdt, "cuda", seed=5)
    before = P.probe_mma.launches
    out = P.try_dtype(tdt, a, b)
    torch.cuda.synchronize()
    assert P.probe_mma.launches == before + 1
    ref = P.probe_mma_plain(a, b)
    torch.testing.assert_close(out, ref, rtol=0, atol=P.TOL * float(ref.abs().max()))
