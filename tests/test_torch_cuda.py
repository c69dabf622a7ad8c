"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; elsewhere every test skips.  Run on
the card from the repository root, without the JAX test configuration:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from latentpose_tpu_torch.ops import adain as adain_op

pytestmark = pytest.mark.cuda

# (H*W, C) of the flagship generator's AdaINs at 256², plus odd sizes
SHAPES = [(16, 512), (1024, 512), (65536, 64), (25, 24), (9, 8)]
TOL = {torch.float32: 2e-4, torch.bfloat16: 1.6e-2}   # bf16: ~2 ulps


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(b, hw, c, dtype, device, broadcast=False):
    g = torch.Generator(device=device).manual_seed(hw * c)
    side = int(round(hw ** 0.5))
    x = torch.randn(b, side, side, c, generator=g, device=device) * 3 + 1
    rows = 1 if broadcast else b
    w, bias = (torch.randn(rows, c, generator=g, device=device)
               .expand(b, c) for _ in range(2))
    return x.to(dtype), w.to(dtype), bias.to(dtype)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c", SHAPES)
def test_adain_kernel_matches_plain(device, hw, c, dtype, relu):
    x, w, b = _inputs(4, hw, c, dtype, device)
    before = adain_op.adain.launches
    got = adain_op.adain(x, w, b, relu=relu)
    torch.cuda.synchronize()
    assert adain_op.adain.launches == before + 1
    want = adain_op.adain_reference(x, w, b, relu=relu)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_adain_kernel_broadcast_affine(device):
    """Row stride 0: one (C,) affine for the whole batch (InstanceNorm
    affine in ResBlock 'in')."""
    x, w, b = _inputs(3, 256, 128, torch.float32, device, broadcast=True)
    assert w.stride(0) == 0
    torch.testing.assert_close(adain_op.adain(x, w, b),
                               adain_op.adain_reference(x, w, b),
                               rtol=2e-4, atol=2e-4)


def test_adain_kernel_refuses_unvectorisable_channels(device):
    x, w, b = _inputs(2, 16, 6, torch.float32, device)
    with pytest.raises(ValueError, match="multiple"):
        adain_op.adain(x, w, b)
