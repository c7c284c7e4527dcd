"""PyTorch port, CUDA kernels against their plain versions on the card.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and skips
without a CUDA device.  The card's machine has no JAX, so run the file
there without the JAX conftest:

    python -m pytest tests/test_torch_port_cuda.py -q -p no:cacheprovider --noconftest

Shapes are small and cover what the 512^2 path does not: other head dims,
scalar (non-16-byte) channel paths, several classes, gate off.  The backward
kernels (K-A', K-C', K3, K4 and the head's two kernels without the gate) are
held against their plain versions, and the gradients of a tiny model through
the kernels against the plain path.  Attention dropout is held mask for mask
against the plain version at every window geometry of ``cswin_simam_512``
and ``cswinunet``.  The long windows: the flash kernels and the tiled K-A /
K-A' against their plain versions at 512, 1024, 2048 (vertical) and 4096
(global) tokens, which kernels each window size launches, and
CSWin-SimAM-UNet at 2048^2 (a forward, a batch-8 forward whose later images
must not see 32-bit offsets wrap, and a training step).  The last six
kernel bodies: K-LN and K-LN' (odd channel counts among them), K5 with and
without the gate (alone and inside the standalone head's autograd
Function), K-V1 and K-V1' (a key mask at n_valid not a multiple of 16, up
to 2048 tokens), the launches of their three entry points, and a
16-class model, whose head takes the unfused chain.
"""

import pytest
import torch

from cswin_simam_unet_tpu_torch import _build
from cswin_simam_unet_tpu_torch.configs import TRAIN_CONFIGS, build_model
from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.models.layers import FusedLayerNorm, FusedSimAMHead
from cswin_simam_unet_tpu_torch.ops import attention, carafe, carafe_head, dropout, layernorm
from cswin_simam_unet_tpu_torch.ops import carafe_kernels, flash_attention, simam_head
from cswin_simam_unet_tpu_torch.ops import stripe_attention, window_attention
from cswin_simam_unet_tpu_torch.ops.simam import pooled_stats
from cswin_simam_unet_tpu_torch.ops.windows import stripe_geometry
from cswin_simam_unet_tpu_torch.train import engine

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


def _check_scaled(got, want, dtype):
    """A backward output, both tolerances times max(1, max|plain|): the LePE
    weight gradient sums over every token of the branch and reaches O(100)."""
    err = float((got.float() - want.float()).abs().max())
    tol = (TOL_F32 if dtype == torch.float32 else TOL_BF16) * max(1.0, float(want.abs().max()))
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
        counts = {k: n for k, n in _build.LAUNCHES.items() if n}
        off = model.predict(x, use_kernels=False)
    assert counts == {stripe_attention.KERNEL: 14, carafe_kernels.KERNEL: 3,
                      carafe_head.MOMENTS_KERNEL: 1, carafe_head.HEAD_KERNEL: 1}
    torch.testing.assert_close(on, off, rtol=1e-4, atol=1e-4)


# ---- backward kernels ----

ATTN_BWD_GEOMS = [
    (16, 1, 0, 8, 1),     # head dim 8, width-1 vertical stripes
    (16, 2, 1, 32, 2),    # head dim 16, horizontal
    (16, 4, 0, 64, 2),    # head dim 32, vertical
    (16, 16, -1, 64, 2),  # head dim 32, 256-token global window (largest of 512^2)
    (8, 8, -1, 128, 2),   # head dim 64, global window
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,split,idx,C,heads", ATTN_BWD_GEOMS)
def test_stripe_attention_bwd_kernel(dev, dtype, H, split, idx, C, heads):
    hsp, wsp = stripe_geometry(H, split, idx)
    qkv = _randn(dev, 2, H * H, 3 * C, scale=0.5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(dtype)
    g = _randn(dev, 2, H * H, 2 * C, seed=2).to(dtype)[..., C:]  # strided cotangent
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads)
    _build.reset_launches()
    got = stripe_attention.attention_bwd(q, k, v, lk, g, **kw)
    assert _build.LAUNCHES[stripe_attention.BWD_KERNEL] == 1
    want = attention.stripe_attention_bwd_reference(q.float(), k.float(), v.float(),
                                                    lk.float(), g.float(), **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype
        _check(a, b, dtype)


def test_stripe_attention_bwd_kernel_rejects(dev):
    q = torch.zeros(1, 256, 128, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        stripe_attention.attention_bwd(q, q, q, torch.zeros(3, 3, 1, 128, device=dev), q,
                                       H=16, W=16, hsp=16, wsp=16, num_heads=2)
    with pytest.raises(ValueError, match="dout"):
        stripe_attention.attention_bwd(q, q, q, torch.zeros(3, 3, 1, 128, device=dev),
                                       q[..., :64], H=16, W=16, hsp=1, wsp=16, num_heads=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,S", [(8, 8, 16, 2), (6, 10, 8, 4), (5, 7, 6, 2),
                                     (4, 20, 64, 2)])
def test_carafe_bwd_kernel(dev, dtype, H, W, C, S):
    x = _randn(dev, 2, H, W, C).to(dtype)
    enc = _randn(dev, 2, H, W, 9 * S * S, seed=1).to(dtype)
    dout = _randn(dev, 2, H, W, S * S * C, seed=2).to(dtype)
    _build.reset_launches()
    got = carafe_kernels.carafe_flat_bwd(x, enc, dout, S)
    assert _build.LAUNCHES[carafe_kernels.BWD_KERNEL] == 1
    want = carafe.carafe_bwd_reference(x.float(), enc.float(), dout.float(), S)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype
        _check(a, b, dtype)


def test_carafe_bwd_kernel_rejects(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    with pytest.raises(ValueError, match="dout"):
        carafe_kernels.carafe_flat_bwd(x, torch.zeros(1, 4, 4, 36, device=dev),
                                       torch.zeros(1, 4, 4, 16, device=dev), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,S,F", [(8, 8, 16, 4, 1), (4, 6, 8, 2, 3), (4, 4, 6, 2, 8),
                                       (6, 20, 64, 4, 1)])
def test_head_bwd_kernels(dev, dtype, H, W, C, S, F):
    G = S * S
    x = _randn(dev, 2, H, W, C).to(dtype)
    enc = _randn(dev, 2, H, W, 9 * G, seed=1).to(dtype)
    fb = _randn(dev, 2, H, W, G * C, seed=2).to(dtype)
    dy = _randn(dev, 2, H, W, G * F, seed=3).to(dtype)
    w = _randn(dev, C, F, scale=C ** -0.5, seed=4)
    f = fb.float()
    mu, v = pooled_stats(f.sum((1, 2)), (f * f).sum((1, 2)), H * W * G, G)
    _build.reset_launches()
    got = carafe_head.head_bwd1(fb, dy, mu, v, w, G)
    assert _build.LAUNCHES[carafe_head.BWD1_KERNEL] == 1
    want = carafe_head.head_bwd1_reference(f, dy.float(), mu, v, w, G)
    for a, b in zip(got, want):
        _check(a, b, dtype)
    A, Bq = want[0], want[1]
    got = carafe_head.fused_head_bwd(x, enc, fb, dy, mu, v, A, Bq, w, S)
    assert _build.LAUNCHES[carafe_head.FUSED_BWD_KERNEL] == 1
    want = carafe_head.fused_head_bwd_reference(x.float(), enc.float(), f, dy.float(), mu,
                                                v, A, Bq, w, S)
    assert got[0].dtype == dtype and got[1].dtype == dtype and got[2].shape == (C,)
    for a, b in zip(got, want):
        _check(a, b, dtype)


def test_head_bwd_kernels_reject(dev):
    fb = torch.zeros(1, 4, 4, 64, device=dev)
    mu = v = torch.zeros(1, 16, device=dev)
    w = torch.zeros(16, 1, device=dev)
    with pytest.raises(ValueError, match="dy"):
        carafe_head.head_bwd1(fb, torch.zeros(1, 4, 4, 8, device=dev), mu, v, w, 4)
    with pytest.raises(ValueError, match="w must be"):
        carafe_head.head_bwd1(fb, torch.zeros(1, 4, 4, 36, device=dev), mu, v,
                              torch.zeros(16, 9, device=dev), 4)
    x = torch.zeros(1, 4, 4, 16, device=dev)
    with pytest.raises(ValueError, match="fb must be"):
        carafe_head.fused_head_bwd(x, torch.zeros(1, 4, 4, 36, device=dev), fb[..., :32],
                                   torch.zeros(1, 4, 4, 4, device=dev), mu, v, mu, v, w, 2)


def test_head_backward_without_simam_raises(dev):
    """The head's backward without SimAM once raised on CUDA; it now runs K3
    and K4 without the gate and matches the plain versions."""
    x = _randn(dev, 1, 4, 4, 8).requires_grad_()
    enc = _randn(dev, 1, 4, 4, 36, seed=1).requires_grad_()
    w = _randn(dev, 8, 1, seed=2)
    out = carafe_head.carafe_simam_head(x, enc, torch.zeros(8, device=dev), w, 2, gate=False)
    _build.reset_launches()
    out.sum().backward()
    assert _build.LAUNCHES[carafe_head.BWD1_NOGATE_KERNEL] == 1
    assert _build.LAUNCHES[carafe_head.FUSED_BWD_NOGATE_KERNEL] == 1
    assert _build.LAUNCHES[carafe_head.BWD1_KERNEL] == 0
    xp, ep = x.detach().requires_grad_(), enc.detach().requires_grad_()
    carafe_head.reference(xp, ep, torch.zeros(8, device=dev), w, 2, gate=False).sum().backward()
    _check(x.grad, xp.grad, torch.float32)
    _check(enc.grad, ep.grad, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,S,F", [(8, 8, 16, 4, 1), (4, 6, 8, 2, 3), (4, 4, 6, 2, 8),
                                       (6, 20, 64, 4, 1)])
def test_head_bwd_nogate_kernels(dev, dtype, H, W, C, S, F):
    G = S * S
    x = _randn(dev, 2, H, W, C).to(dtype)
    enc = _randn(dev, 2, H, W, 9 * G, seed=1).to(dtype)
    fb = _randn(dev, 2, H, W, G * C, seed=2).to(dtype)
    dy = _randn(dev, 2, H, W, G * F, seed=3).to(dtype)
    w = _randn(dev, C, F, scale=C ** -0.5, seed=4)
    _build.reset_launches()
    got = carafe_head.head_bwd1(fb, dy, None, None, w, G, gate=False)
    assert _build.LAUNCHES[carafe_head.BWD1_NOGATE_KERNEL] == 1
    want = carafe_head.head_bwd1_reference(fb.float(), dy.float(), None, None, w, G,
                                           gate=False)
    assert got[0] is None and got[1] is None
    _check(got[2], want[2], dtype)
    got = carafe_head.fused_head_bwd(x, enc, fb, dy, None, None, None, None, w, S, gate=False)
    assert _build.LAUNCHES[carafe_head.FUSED_BWD_NOGATE_KERNEL] == 1
    want = carafe_head.fused_head_bwd_reference(x.float(), enc.float(), fb.float(),
                                                dy.float(), None, None, None, None, w, S,
                                                gate=False)
    assert got[0].dtype == dtype and got[1].dtype == dtype and got[2].shape == (C,)
    for a, b in zip(got, want):
        _check(a, b, dtype)


# ---- attention dropout in K-A and K-A' ----

# every branch geometry of cswin_simam_512 and cswinunet: (H, hsp, wsp, Cb, heads)
DROP_GEOMS = [
    (128, 128, 1, 32, 1), (128, 1, 128, 32, 1), (64, 64, 2, 64, 2), (64, 2, 64, 64, 2),
    (32, 32, 8, 128, 4), (32, 8, 32, 128, 4), (16, 16, 16, 512, 16),
    (112, 112, 1, 32, 1), (112, 1, 112, 32, 1), (56, 56, 2, 64, 2), (56, 2, 56, 64, 2),
    (28, 28, 7, 128, 4), (28, 7, 28, 128, 4), (14, 14, 14, 512, 16),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hsp,wsp,C,heads", DROP_GEOMS)
def test_stripe_attention_dropout_kernels(dev, dtype, H, hsp, wsp, C, heads):
    """K-A and K-A' at rate 0.3 against the plain versions with the hash
    mask of the same seed; q, k, v strided thirds of one tensor."""
    qkv = _randn(dev, 1, H * H, 3 * C, scale=0.5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(dtype)
    g = _randn(dev, 1, H * H, C, seed=2).to(dtype)
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=0.3, seed=2 ** 31 + 7)
    f32 = [t.float() for t in (q, k, v, lk, g)]
    got = stripe_attention.attention_fwd(q, k, v, lk, **kw)
    want = attention.stripe_attention(*f32[:4], **kw)
    _check(got, want, dtype)
    nodrop = attention.stripe_attention(*f32[:4], **{**kw, "attn_drop": 0.0})
    assert float((want - nodrop).abs().max()) > 1e-2
    got = stripe_attention.attention_bwd(q, k, v, lk, g, **kw)
    want = attention.stripe_attention_bwd_reference(*f32, **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype
        _check(a, b, dtype)


def test_attention_keep_rate_from_kernel(dev):
    """q = k = 0 and v = 1, no LePE: each output of K-A is the kept share of
    its row over 0.7, so the kernel's keep rate reads back from its output;
    it lies within 4 sigma of 1 - threshold / 2^32."""
    H, C, heads = 128, 32, 1
    zeros = torch.zeros(2, H * H, C, device=dev)
    ones = torch.ones(2, H * H, C, device=dev)
    out = stripe_attention.attention_fwd(zeros, zeros, ones, torch.zeros(3, 3, 1, C, device=dev),
                                         H=H, W=H, hsp=H, wsp=1, num_heads=heads,
                                         attn_drop=0.3, seed=5)
    n = 2 * H * H * H
    p_keep = 1 - dropout.u32_threshold(0.3) / 2 ** 32
    rate = float(out[..., 0].double().mean()) * 0.7
    assert abs(rate - p_keep) <= 4 * (p_keep * (1 - p_keep) / n) ** 0.5, rate


def test_attention_dropout_rate_zero_launches_unchanged(dev):
    """attn_drop 0 with a seed is the no-dropout kernel: bitwise the same."""
    qkv = _randn(dev, 2, 256, 96, scale=0.5)
    q, k, v = qkv[..., :32], qkv[..., 32:64], qkv[..., 64:]
    lk = _randn(dev, 3, 3, 1, 32, seed=1)
    kw = dict(H=16, W=16, hsp=16, wsp=2, num_heads=1)
    assert torch.equal(stripe_attention.attention_fwd(q, k, v, lk, **kw),
                       stripe_attention.attention_fwd(q, k, v, lk, **kw, attn_drop=0.0,
                                                      seed=3))


# ---- gradients of a tiny model through the kernels ----

TINY = dict(img_size=64, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2),
            num_heads=(2, 2, 4, 8))


def _grads(model, x, use_kernels, fn):
    model.zero_grad(set_to_none=True)
    fn(model, x, use_kernels).backward()
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def _loss(model, x, use_kernels):
    logits = model(x, use_kernels=use_kernels, flat_logits=True).float()
    return (logits * torch.cos(logits)).mean()


@pytest.mark.parametrize("use_simam", [True, False])
def test_tiny_model_grads_match_plain(dev, use_simam):
    """Every parameter's gradient through the kernels against the plain
    path: the head's backward runs K3 and K4 with SimAM, and their variants
    without the gate without it."""
    model = CSWinUNet(**TINY, use_simam=use_simam, device=dev, seed=3)
    x = torch.rand(2, 64, 64, 3, device=dev)
    _build.reset_launches()
    on = _grads(model, x, True, _loss)
    counts = dict(_build.LAUNCHES)
    off = _grads(model, x, False, _loss)
    assert counts[stripe_attention.BWD_KERNEL] == 14
    assert counts[carafe_kernels.BWD_KERNEL] == 3
    assert counts[carafe_head.BWD1_KERNEL] == counts[carafe_head.FUSED_BWD_KERNEL] == int(
        use_simam)
    assert counts[carafe_head.BWD1_NOGATE_KERNEL] == int(not use_simam)
    assert counts[carafe_head.FUSED_BWD_NOGATE_KERNEL] == int(not use_simam)
    assert set(on) == set(off) and len(on) > 0
    for name, g in off.items():
        err = float((on[name] - g).abs().max())
        assert err <= 1e-3 * max(float(g.abs().max()), 1e-12), (name, err)


def test_kernel_path_reaches_qkv_weights(dev):
    """Regression: K-A, K-C and the head once wrote their outputs through
    ctypes into fresh tensors and cut the autograd graph; the qkv weight of
    every block then got no gradient through the kernel path."""
    model = CSWinUNet(**TINY, use_simam=True, device=dev, seed=4)
    x = torch.rand(1, 64, 64, 3, device=dev)
    on = _grads(model, x, True, _loss)
    off = _grads(model, x, False, _loss)
    for name in ("stage1.0.qkv.weight", "stage3.0.qkv.weight", "stage_up1.0.qkv.weight",
                 "upsample2.encoder.weight", "upsample1.encoder.weight"):
        assert name in on and float(on[name].abs().max()) > 0, name
        err = float((on[name] - off[name]).abs().max())
        assert err <= 1e-3 * float(off[name].abs().max()), (name, err)


def test_train_step_on_card(dev):
    model = CSWinUNet(**TINY, use_simam=True, device=dev, seed=6)
    opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
    step = engine.make_train_step(model, opt)
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 64, 64, 3), generator=gen, dtype=torch.uint8)
    masks = (torch.randint(0, 2, (2, 64, 64, 1), generator=gen) * 255).to(torch.uint8)
    hist = [{k: float(v) for k, v in step(images, masks).items()} for _ in range(5)]
    assert all(0.0 <= h["dice"] <= 1.0 and 0.0 <= h["iou"] <= 1.0 for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]


@pytest.mark.parametrize("use_simam", [True, False])
def test_train_step_at_drops_kernels_match_plain(dev, use_simam):
    """Drops 0.3, one seed: the kernels and the plain path drop the same
    elements, so float32 gradients agree; predict after the step is eval."""
    model = CSWinUNet(**TINY, use_simam=use_simam, drop_rate=0.3, attn_drop_rate=0.3,
                      drop_path_rate=0.3, device=dev, seed=7)
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (2, 64, 64, 3), generator=gen, dtype=torch.uint8)
    masks = (torch.randint(0, 2, (2, 64, 64, 1), generator=gen) * 255).to(torch.uint8)
    grads = []
    for use_kernels in (True, False):
        model.zero_grad(set_to_none=True)
        loss, _, _ = engine.compute_gradients(model, images, masks, 1, use_kernels, rng=17)
        grads.append((float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert abs(grads[0][0] - grads[1][0]) <= 1e-4
    for name, g in grads[1][1].items():
        err = float((grads[0][1][name] - g).abs().max())
        assert err <= 1e-3 * max(float(g.abs().max()), 1e-12), (name, err)
    x = images.to(dev).float() / 255
    with torch.inference_mode():
        torch.testing.assert_close(model.predict(x), torch.sigmoid(model(x)), rtol=0, atol=0)


# ---- long windows: the flash kernels and the tiled K-A / K-A' ----

# (H, hsp, wsp, C, heads): 512, 1024, 2048 (vertical) and 4096 (global) tokens
LONG_GEOMS = [(64, 64, 8, 64, 2), (128, 128, 8, 32, 1), (256, 256, 8, 32, 1),
              (64, 64, 64, 64, 2)]


def _long_inputs(dev, dtype, H, C, B=1):
    qkv = _randn(dev, B, H * H, 3 * C, scale=0.5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(dtype)
    g = _randn(dev, B, H * H, C, seed=2).to(dtype)
    return q, k, v, lk, g


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hsp,wsp,C,heads", LONG_GEOMS)
def test_tiled_attention_kernels(dev, dtype, rate, H, hsp, wsp, C, heads):
    """The tiled K-A and K-A' (window mode) against the plain v2 versions,
    mask for mask, every output."""
    q, k, v, lk, g = _long_inputs(dev, dtype, H, C)
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=rate, seed=2 ** 31 + 9)
    f32 = [t.float() for t in (q, k, v, lk, g)]
    _build.reset_launches()
    out, lse = stripe_attention.tiled_fwd(q, k, v, lk, **kw)
    got = stripe_attention.tiled_bwd(q, k, v, lk, lse, g, **kw)
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        stripe_attention.TILED_KERNEL: 1, **{n: 1 for n in stripe_attention.TILED_BWD_KERNELS}}
    _check(out, attention.stripe_attention(*f32[:4], **kw), dtype)
    want = attention.stripe_attention_bwd_reference(*f32, **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype
        _check_scaled(a, b, dtype)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hsp,wsp,C,heads", LONG_GEOMS)
def test_flash_kernels(dev, dtype, rate, H, hsp, wsp, C, heads):
    """The flash fwd, dq and dkv kernels (flash mode, band layout, mask tiles
    of pick_tile(N)) against the plain flash versions on the same bands; the
    backward from the plain forward's O and L, so each kernel is held alone."""
    q, k, v, lk, g = _long_inputs(dev, dtype, H, C, B=2)
    flip, Ht, Wt, wht = flash_attention.band_geometry(H, H, hsp, wsp)
    if flip:
        q, k, v, g = (t.reshape(2, H, H, C).transpose(1, 2).reshape(2, H * H, C).contiguous()
                      for t in (q, k, v, g))
    geo = dict(H=Ht, W=Wt, hsp=wht, wsp=Wt, num_heads=heads, attn_drop=rate, seed=77)
    N = wht * Wt
    bands = [t.reshape(-1, N, C) for t in (q, k, v, g)]
    ref_kw = dict(heads=heads, attn_drop=rate, seed=77)
    out_ref, lse_ref = flash_attention.flash_attention_reference(
        *[t.float() for t in bands[:3]], **ref_kw)
    _build.reset_launches()
    out, lse = flash_attention.kernel_fwd(q, k, v, None, **geo, mode="flash")
    _check(out.reshape(out_ref.shape), out_ref, dtype)
    _check(lse, lse_ref, dtype)
    o = out_ref.to(dtype).reshape(q.shape)
    delta = flash_attention.flash_delta(o.reshape(-1, N, C), g.reshape(-1, N, C), heads)
    dq, dk, dv, dw = flash_attention.kernel_bwd(q, k, v, None, lse_ref, g, **geo, delta=delta,
                                                mode="flash")
    assert dw is None
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        f"{n}:flash": 1 for n in (flash_attention.FWD_KERNEL, flash_attention.DQ_KERNEL,
                                  flash_attention.DKV_KERNEL)}
    want = flash_attention.flash_attention_bwd_reference(
        *[t.float() for t in bands[:3]], o.reshape(-1, N, C).float(), lse_ref,
        bands[3].float(), **ref_kw)
    for a, b in zip((dq, dk, dv), want):
        _check_scaled(a.reshape(b.shape), b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hsp,wsp,C,heads", [
    (16, 16, 16, 32, 1), (16, 16, 2, 64, 2), (14, 1, 14, 32, 1),
    (16, 16, 1, 8, 1),     # head dim 8
    (16, 2, 16, 32, 2),    # head dim 16
    (8, 8, 8, 128, 2),     # head dim 64: two lanes share a row
])
def test_tiled_matches_whole_window(dev, dtype, H, hsp, wsp, C, heads):
    """At windows K-A and K-A' hold whole, the tiled entry computes the same
    function with the same dropout mask."""
    q, k, v, lk, g = _long_inputs(dev, dtype, H, C, B=2)
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=0.3, seed=5)
    out, lse = stripe_attention.tiled_fwd(q, k, v, lk, **kw)
    _check(out, stripe_attention.attention_fwd(q, k, v, lk, **kw).float(), dtype)
    got = stripe_attention.tiled_bwd(q, k, v, lk, lse, g, **kw)
    want = stripe_attention.attention_bwd(q, k, v, lk, g, **kw)
    for a, b in zip(got, want):
        _check_scaled(a, b.float(), dtype)


# (H, W, hsp, wsp, C, heads): head dims 8, 16 and 64, a ragged 400-token
# window, and a 20 x 26 global window whose flash mask tiles (104 tokens,
# pick_tile(520)) are not a multiple of the kernels' 32-row tiles
ODD_GEOMS = [(32, 32, 16, 32, 16, 2), (64, 64, 8, 64, 32, 2), (32, 32, 16, 32, 128, 2),
             (20, 20, 20, 20, 32, 1), (20, 26, 20, 26, 32, 1)]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,hsp,wsp,C,heads", ODD_GEOMS)
def test_long_window_kernels_odd_shapes(dev, dtype, rate, H, W, hsp, wsp, C, heads):
    """Both modes of the family at the head dims and sizes the path does not
    use, every output against its plain version."""
    qkv = _randn(dev, 2, H * W, 3 * C, scale=0.5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(dtype)
    g = _randn(dev, 2, H * W, C, seed=2).to(dtype)
    kw = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=rate, seed=11)
    f32 = [t.float() for t in (q, k, v, lk, g)]
    out, lse = stripe_attention.tiled_fwd(q, k, v, lk, **kw)
    _check(out, attention.stripe_attention(*f32[:4], **kw), dtype)
    got = stripe_attention.tiled_bwd(q, k, v, lk, lse, g, **kw)
    for a, b in zip(got, attention.stripe_attention_bwd_reference(*f32, **kw)):
        _check_scaled(a, b, dtype)
    N = hsp * wsp
    ref_kw = dict(heads=heads, attn_drop=rate, seed=11)
    bands = [t.reshape(-1, N, C) for t in (f32[0], f32[1], f32[2], f32[4])]  # q, k, v, g
    out_ref, lse_ref = flash_attention.flash_attention_reference(*bands[:3], **ref_kw)
    out, lse = flash_attention.kernel_fwd(q, k, v, None, **kw, mode="flash")
    _check(out.reshape(out_ref.shape), out_ref, dtype)
    _check(lse, lse_ref, dtype)
    o = out_ref.to(dtype)
    delta = flash_attention.flash_delta(o, g.reshape(-1, N, C), heads)
    got = flash_attention.kernel_bwd(q, k, v, None, lse_ref, g, **kw, delta=delta, mode="flash")
    want = flash_attention.flash_attention_bwd_reference(*bands[:3], o.float(), lse_ref,
                                                         bands[3], **ref_kw)
    for a, b in zip(got[:3], want):
        _check_scaled(a.reshape(b.shape), b, dtype)


def test_dispatch_launches_by_window_size(dev):
    """Through ``stripe_attention`` with its gradient: the flagship's largest
    window (256 tokens) launches K-A / K-A', 512 and 2048 tokens the tiled
    pair, 4096 the flash kernels."""
    cases = [((16, 16, 16, 64, 2), {stripe_attention.KERNEL: 1, stripe_attention.BWD_KERNEL: 1}),
             ((64, 64, 8, 32, 1), {stripe_attention.TILED_KERNEL: 1,
                                   **{n: 1 for n in stripe_attention.TILED_BWD_KERNELS}}),
             ((256, 256, 8, 32, 1), {stripe_attention.TILED_KERNEL: 1,
                                     **{n: 1 for n in stripe_attention.TILED_BWD_KERNELS}}),
             ((64, 64, 64, 64, 2), {f"{n}:flash": 1 for n in (
                 flash_attention.FWD_KERNEL, flash_attention.DQ_KERNEL,
                 flash_attention.DKV_KERNEL)})]
    for (H, hsp, wsp, C, heads), want in cases:
        q, k, v, lk, g = _long_inputs(dev, torch.bfloat16, H, C)
        q, k, v, lk = (t.detach().requires_grad_() for t in (q, k, v, lk))
        _build.reset_launches()
        out = stripe_attention.stripe_attention(q, k, v, lk, H=H, W=H, hsp=hsp, wsp=wsp,
                                                num_heads=heads)
        out.backward(g)
        assert {n: c for n, c in _build.LAUNCHES.items() if c} == want, (H, hsp, wsp)
        assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
                   for t in (q, k, v, lk))


def test_model_2048_forward_and_training_step(dev):
    """CSWin-SimAM-UNet at 2048^2, full width, bf16: per forward the tiled
    K-A runs 48 times and the flash forward twice; per training step the
    tiled K-A' and the flash backward as often; the step's loss is finite."""
    model = build_model("cswin_simam_2048", device=dev, seed=0)
    x = torch.rand(1, 2048, 2048, 3, device=dev)
    _build.reset_launches()
    with torch.inference_mode():
        p = model.predict(x)
    counts = {n: c for n, c in _build.LAUNCHES.items() if c}
    assert counts[stripe_attention.TILED_KERNEL] == 48
    assert counts[f"{flash_attention.FWD_KERNEL}:flash"] == 2
    assert stripe_attention.KERNEL not in counts
    assert p.shape == (1, 2048, 2048, 1) and bool(torch.isfinite(p).all())
    opt = engine.make_optimizer("adamw", 1e-4, 1e-4, model.parameters())
    step = engine.make_train_step(model, opt, seed=0)
    images = (x[..., :3] * 255).to(torch.uint8)
    masks = ((x[..., :1] > 0.5) * 255).to(torch.uint8)
    _build.reset_launches()
    out = step(images, masks)
    counts = {n: c for n, c in _build.LAUNCHES.items() if c}
    for name in stripe_attention.TILED_BWD_KERNELS:
        assert counts[name] == 48, counts
    for name in (flash_attention.DQ_KERNEL, flash_attention.DKV_KERNEL):
        assert counts[f"{name}:flash"] == 2, counts
    assert all(bool(torch.isfinite(torch.as_tensor(val))) for val in out.values())
    assert TRAIN_CONFIGS["cswin_simam_2048"].batch_size == 1


def test_model_2048_batch8_offsets(dev):
    """A batch-8 forward at 2048^2: the head's flat map holds 8 * 512^2 * 1024
    > 2^31 elements, so a kernel with 32-bit offsets would wrap; the last
    image must come out as it does alone."""
    model = build_model("cswin_simam_2048", device=dev, seed=1)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand(8, 2048, 2048, 3, device=dev, generator=gen)
    with torch.inference_mode():
        p8 = model.predict(x)
        p1 = model.predict(x[7:])
    assert bool(torch.isfinite(p8).all())
    assert float((p8[7:].float() - p1.float()).abs().max()) <= 5e-2


# ---- the last six kernel bodies: K-LN, K-LN', K5 (with and without the
# gate), K-V1, K-V1' ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C", [(200, 64), (131, 96), (64, 512), (37, 33), (70, 8)])
def test_layernorm_kernels(dev, dtype, M, C):
    x = (_randn(dev, M, C, scale=2.0) + 0.5).to(dtype)
    dy = _randn(dev, M, C, seed=1).to(dtype)
    g = _randn(dev, C, scale=0.3, seed=2) + 1.0
    b = _randn(dev, C, scale=0.1, seed=3)
    _build.reset_launches()
    y = layernorm.kernel_fwd(x, g, b)
    got = layernorm.kernel_bwd(x, g, dy)
    assert _build.LAUNCHES[layernorm.FWD_KERNEL] == _build.LAUNCHES[layernorm.BWD_KERNEL] == 1
    assert y.dtype == got[0].dtype == dtype and got[1].dtype == torch.float32
    _check(y, layernorm.ln_reference(x.float(), g, b), dtype)
    for a, r in zip(got, layernorm.ln_bwd_reference(x.float(), g, dy.float())):
        _check_scaled(a, r, dtype)


def test_layernorm_kernel_rejects(dev):
    with pytest.raises(ValueError, match="channels"):
        layernorm.kernel_fwd(torch.zeros(4, 520, device=dev), torch.ones(520, device=dev),
                             torch.zeros(520, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("H,W,C,G,F", [(8, 8, 16, 16, 1), (4, 6, 8, 4, 3), (4, 4, 6, 4, 8),
                                       (6, 20, 64, 16, 4)])
def test_head_bwd2_kernels(dev, dtype, gate, H, W, C, G, F):
    fb = _randn(dev, 2, H, W, G * C, seed=2).to(dtype)
    dy = _randn(dev, 2, H, W, G * F, seed=3).to(dtype)
    w = _randn(dev, C, F, scale=C ** -0.5, seed=4)
    f = fb.float()
    mu, v = pooled_stats(f.sum((1, 2)), (f * f).sum((1, 2)), H * W * G, G)
    A, Bq, _ = carafe_head.head_bwd1_reference(f, dy.float(), mu, v, w, G, gate=gate)
    _build.reset_launches()
    got = simam_head.head_bwd2(fb, dy, mu, v, A, Bq, w, G, gate=gate)
    name = simam_head.BWD2_KERNEL if gate else simam_head.BWD2_NOGATE_KERNEL
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {name: 1}
    want = carafe_head.head_bwd2_reference(f, dy.float(), mu, v, A, Bq, w, G, gate=gate)
    assert got[0].dtype == dtype and got[1].shape == (C,)
    for a, r in zip(got, want):
        _check_scaled(a, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("F", [1, 3])
def test_simam_head_function(dev, dtype, gate, F):
    """The standalone head through autograd: K-H2 forward, K3 and K5 backward
    (each once), against the plain head differentiated by autograd."""
    G, C = 16, 16
    x = _randn(dev, 2, 8, 8, G * C).to(dtype).requires_grad_()
    b = _randn(dev, C, scale=0.1, seed=1).to(dtype).requires_grad_()
    w = _randn(dev, C, F, scale=C ** -0.5, seed=2).requires_grad_()
    dy = _randn(dev, 2, 8, 8, G * F, seed=3).to(dtype)
    _build.reset_launches()
    out = simam_head.simam_head(x, b, w, G, 1e-4, gate)
    out.backward(dy)
    want_launches = {carafe_head.HEAD_KERNEL: 1,
                     carafe_head.BWD1_KERNEL if gate else carafe_head.BWD1_NOGATE_KERNEL: 1,
                     simam_head.BWD2_KERNEL if gate else simam_head.BWD2_NOGATE_KERNEL: 1}
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == want_launches
    leaves = [t.detach().float().requires_grad_() for t in (x, b, w)]
    ref = carafe_head.head_reference(*leaves, G, 1e-4, gate)
    ref.backward(dy.float())
    _check(out.detach(), ref.detach(), dtype)
    for t, r in zip((x, b, w), leaves):
        _check_scaled(t.grad, r.grad, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Np,n_valid,D", [(6, 16, 16, 8), (4, 112, 98, 16),
                                            (3, 208, 196, 32), (2, 256, 256, 64),
                                            (1, 2048, 2041, 32)])
def test_window_attention_kernels(dev, dtype, G, Np, n_valid, D):
    q, k, v, do = (_randn(dev, G, Np, D, scale=0.5, seed=s).to(dtype) for s in range(4))
    scale = D ** -0.5
    _build.reset_launches()
    out, lse = window_attention.kernel_fwd(q, k, v, scale, n_valid)
    got = window_attention.kernel_bwd(q, k, v, lse, do, scale, n_valid)
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        window_attention.FWD_KERNEL: 1, window_attention.BWD_KERNEL: 1}
    qf, kf, vf = q.float(), k.float(), v.float()
    _check(out, window_attention.window_attention_reference(qf, kf, vf, scale, n_valid), dtype)
    want = window_attention.window_attention_bwd_reference(qf, kf, vf, do.float(), scale,
                                                           n_valid)
    for a, r in zip(got, want):
        _check_scaled(a, r, dtype)
    assert float(got[1][:, n_valid:].abs().sum()) == 0.0  # masked keys: dk = dv = 0
    assert float(got[2][:, n_valid:].abs().sum()) == 0.0


def test_window_attention_kernel_rejects(dev):
    x = torch.zeros(1, 2064, 32, device=dev)
    with pytest.raises(ValueError, match="at most 2048 tokens"):
        window_attention.window_attention(x, x, x, 1.0, 2064)
    x = torch.zeros(1, 16, 24, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        window_attention.kernel_fwd(x, x, x, 1.0, 16)


def test_entry_points_launch_their_kernels(dev):
    """The three entry points of the last six kernels, forward and backward:
    FusedLayerNorm(use_kernel=True), FusedSimAMHead (F <= 8) and
    stripe_attention_v1; and the v1 entry's dropout fallback, which
    launches nothing."""
    ln = FusedLayerNorm(64, use_kernel=True).to(dev)
    with torch.no_grad():
        ln.weight.fill_(1.0)
        ln.bias.zero_()
    x = _randn(dev, 2, 100, 64).to(torch.bfloat16).requires_grad_()
    _build.reset_launches()
    ln(x).float().sum().backward()
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        layernorm.FWD_KERNEL: 1, layernorm.BWD_KERNEL: 1}
    head = FusedSimAMHead(16, 4, 16).to(dev)
    with torch.no_grad():
        head.weight.copy_(_randn(dev, 4, 16, 1, 1, scale=0.25))
    fb = _randn(dev, 2, 8, 8, 256, seed=1).to(torch.bfloat16).requires_grad_()
    _build.reset_launches()
    head(fb, torch.zeros(16, device=dev, dtype=torch.bfloat16)).float().sum().backward()
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        carafe_head.HEAD_KERNEL: 1, carafe_head.BWD1_KERNEL: 1, simam_head.BWD2_KERNEL: 1}
    q, k, v = (_randn(dev, 2, 14 * 14, 32, scale=0.5, seed=s).requires_grad_()
               for s in range(3))
    lk = _randn(dev, 3, 3, 1, 32, scale=0.2, seed=4)
    kw = dict(H=14, W=14, hsp=14, wsp=7, num_heads=2)
    _build.reset_launches()
    window_attention.stripe_attention_v1(q, k, v, lk, **kw).sum().backward()
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        window_attention.FWD_KERNEL: 1, window_attention.BWD_KERNEL: 1}
    _build.reset_launches()
    window_attention.stripe_attention_v1(q, k, v, lk, **kw, attn_drop=0.3,
                                         deterministic=False, seed=7).sum().backward()
    assert not any(_build.LAUNCHES.values())


def test_tiny_model_sixteen_classes(dev):
    """Above 8 classes the head takes the unfused chain (K-C, then simam_flat
    and flat_grouped_dot): kernels on against off, and no K-H1/K-H2, K-LN or
    K-V1 launch."""
    model = CSWinUNet(img_size=64, embed_dim=16, depth=(1, 1, 1, 1),
                      split_size=(1, 2, 2, 2), num_heads=(2, 2, 4, 8), num_classes=16,
                      use_simam=True, device=dev, seed=3)
    x = torch.rand(2, 64, 64, 3, device=dev)
    _build.reset_launches()
    with torch.inference_mode():
        on = model.predict(x, use_kernels=True)
        counts = {k: n for k, n in _build.LAUNCHES.items() if n}
        off = model.predict(x, use_kernels=False)
    assert counts == {stripe_attention.KERNEL: 14, carafe_kernels.KERNEL: 4}
    assert on.shape == (2, 64, 64, 16)
    torch.testing.assert_close(on, off, rtol=1e-4, atol=1e-4)
