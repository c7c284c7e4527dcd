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
and ``cswinunet``.
"""

import pytest
import torch

from cswin_simam_unet_tpu_torch import _build
from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.ops import attention, carafe, carafe_head, dropout
from cswin_simam_unet_tpu_torch.ops import carafe_kernels, stripe_attention
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
