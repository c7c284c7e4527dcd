"""PyTorch port, CUDA kernels against their plain versions on the card.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and skips
without a CUDA device.  The card's machine has no JAX, so run the file
there without the JAX conftest:

    python -m pytest tests/test_torch_port_cuda.py -q -p no:cacheprovider --noconftest

Shapes are small and cover what the 512^2 serving path does not: other head
dims, scalar (non-16-byte) channel paths, several classes, gate off.
"""

import pytest
import torch

from cswin_simam_unet_tpu_torch import _build
from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.ops import attention, carafe, carafe_head
from cswin_simam_unet_tpu_torch.ops import carafe_kernels, stripe_attention
from cswin_simam_unet_tpu_torch.ops.simam import pooled_stats
from cswin_simam_unet_tpu_torch.ops.windows import stripe_geometry

pytestmark = pytest.mark.cuda

TOL_F32 = 1e-4   # absolute, float32
TOL_BF16 = 2e-2  # times max(1, max|plain|), bf16 against plain float32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with --noconftest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev) * scale


def _check(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16 * max(1.0, float(want.abs().max()))
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,split,idx,C,heads", [
    (16, 1, 0, 8, 1),     # head dim 8, width-1 vertical stripes
    (16, 2, 1, 32, 2),    # head dim 16, horizontal
    (16, 4, 0, 64, 2),    # head dim 32, vertical
    (8, 8, -1, 128, 2),   # head dim 64, global window
])
def test_stripe_attention_kernel(dev, dtype, H, split, idx, C, heads):
    hsp, wsp = stripe_geometry(H, split, idx)
    qkv = _randn(dev, 2, H * H, 3 * C, scale=0.5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(dtype)
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads)
    got = stripe_attention.stripe_attention(q, k, v, lk, **kw)
    want = attention.stripe_attention(q.float(), k.float(), v.float(), lk.float(), **kw)
    _check(got, want, dtype)


def test_stripe_attention_kernel_rejects(dev):
    q = torch.zeros(1, 64, 24, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        stripe_attention.stripe_attention(q, q, q, torch.zeros(3, 3, 1, 24, device=dev),
                                          H=8, W=8, hsp=8, wsp=1, num_heads=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,S", [(8, 8, 16, 2), (6, 10, 8, 4), (5, 7, 6, 2)])
def test_carafe_kernel(dev, dtype, H, W, C, S):
    x = _randn(dev, 2, H, W, C).to(dtype)
    enc = _randn(dev, 2, H, W, 9 * S * S, seed=1).to(dtype)
    got = carafe_kernels.carafe_flat(x, enc, S)
    _check(got, carafe.carafe_flat(x.float(), enc.float(), S), dtype)


def test_carafe_kernel_rejects_strided(dev):
    x = torch.zeros(1, 4, 8, 8, device=dev)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        carafe_kernels.carafe_flat(x, torch.zeros(1, 4, 4, 36, device=dev), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("H,W,C,S,F", [(8, 8, 16, 4, 1), (4, 6, 8, 2, 3), (4, 4, 6, 2, 8)])
def test_carafe_simam_head_kernels(dev, dtype, gate, H, W, C, S, F):
    x = _randn(dev, 2, H, W, C).to(dtype)
    enc = _randn(dev, 2, H, W, 9 * S * S, seed=1).to(dtype)
    b = _randn(dev, C, scale=0.1, seed=2).to(dtype)
    w = _randn(dev, C, F, seed=3).to(dtype)
    _build.reset_launches()
    got = carafe_head.carafe_simam_head(x, enc, b, w, S, 3, 1e-4, gate)
    assert _build.LAUNCHES[carafe_head.MOMENTS_KERNEL] == 1
    assert _build.LAUNCHES[carafe_head.HEAD_KERNEL] == 1
    want = carafe_head.reference(x.float(), enc.float(), b.float(), w.float(), S, 3, 1e-4,
                                 gate)
    assert got.shape == (2, H, W, S * S * F)
    _check(got, want, dtype)


def test_carafe_head_moments(dev):
    x = _randn(dev, 2, 8, 8, 16)
    enc = _randn(dev, 2, 8, 8, 144, seed=1)
    fb, s1, s2 = carafe_head.carafe_biased_moments(x, enc, torch.zeros(16, device=dev), 4)
    G = 16
    mu, v = pooled_stats(s1.reshape(2, -1, G * 16).sum(1), s2.reshape(2, -1, G * 16).sum(1),
                         8 * 8 * G, G)
    mu_p, v_p = pooled_stats(fb.sum((1, 2)), (fb * fb).sum((1, 2)), 8 * 8 * G, G)
    torch.testing.assert_close(mu, mu_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v, v_p, rtol=1e-5, atol=1e-6)
    assert carafe_head.carafe_biased_moments(x, enc, torch.zeros(16, device=dev), 4,
                                             gate=False)[1] is None


@pytest.mark.parametrize("use_simam", [True, False])
def test_tiny_model_kernels_match_plain(dev, use_simam):
    model = CSWinUNet(img_size=64, embed_dim=16, depth=(1, 1, 1, 1),
                      split_size=(1, 2, 2, 2), num_heads=(2, 2, 4, 8),
                      use_simam=use_simam, device=dev, seed=3)
    x = torch.rand(2, 64, 64, 3, device=dev)
    _build.reset_launches()
    with torch.inference_mode():
        on = model.predict(x, use_kernels=True)
        counts = dict(_build.LAUNCHES)
        off = model.predict(x, use_kernels=False)
    assert counts == {stripe_attention.KERNEL: 14, carafe_kernels.KERNEL: 3,
                      carafe_head.MOMENTS_KERNEL: 1, carafe_head.HEAD_KERNEL: 1}
    torch.testing.assert_close(on, off, rtol=1e-4, atol=1e-4)
