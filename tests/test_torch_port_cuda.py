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
kernel bodies: K-LN and K-LN' at every LayerNorm shape of the configs and at
odd ones (a single row, ragged last blocks, channel counts off the vector
width), dx, dg and db each also at its own scale, the body K-LN' took
(16-byte or scalar loads, unaligned rows among them), two K-LN' runs bitwise
equal and the wrapper's mirror of its launch shape against the C entry's; K5 with and
without the gate (alone and inside the standalone head's autograd
Function), K-V1 and K-V1' (a key mask at n_valid not a multiple of 16, up
to 2048 tokens), the launches of their three entry points, and a
16-class model, whose head takes the unfused chain.  The flash family's
bf16 tensor-core dq and dk/dv: both modes at windows that are not
multiples of their 64-row tiles, mask tiles that do not divide them, head
dims 16, 32 and 64, batch 2; which body each dtype and head dim launches;
unaligned rows; and the bodies a 2048^2 training step launches.  The bf16
tensor-core forwards, K-A and the flash forward, the same way: K-A at
windows of 128 to 384 tokens (tails among them), the flash forward at the
backward's geometries in both modes with its L, very negative scores, and
the bodies a 512^2 forward launches.  The tensor-core K-A' (the tiled
K-A' dq and dk/dv launched from the K-A' entry at the whole-window mask,
from the L that K-A saves) at K-A's windows, head dims and rates, with the
LePE and without it, each output also at its own scale; which body each dtype and
head dim launches; the L K-A saves; unaligned rows; very negative scores;
and the bodies a 512^2 and a cswinunet training step launch.  Every K-A'
and tiled K-A' check also runs with zero LePE taps, where dv is P^T dO
alone.  The head's backward, K3 and K4 with and without the gate: odd
channel counts, a single row, W below a strip, 1, 3 and 8 classes, K4 at
blocks (rows, px) that cross the image every way, each bf16 output also at
its own scale; two calls bitwise equal; and the branch-free division and
reciprocal of K3's gate (common.cuh) against / bit for bit.  The head's
forward, K-H1 and K-H2: the 512^2 and 448^2 heads, chunks that do not
divide the image, odd channel counts, 1, 3 and 8 classes, gate on and off,
each bf16 output also at its own scale; K-H1's per-channel moment sums; two
calls bitwise equal; and K-H2's gate against K3's bit for bit (one-hot W
columns against a one-hot dy).  K-V1 and K-V1' in bf16 at head dims 16, 32
and 64 on the tensor cores (the whole-window K-V1' up to 256 tokens, the
tiled bodies above): the flagship's windows, cswinunet's padded ones, 512
and 2048 tokens, a single attended key, G 1, 3 and 5, every output also at
its own scale and the body each launch took; the wrapper's choice of body
against the C entry's; two runs bitwise equal; and a key whose logit is 30
above the rest.  Training beyond the binary step: the 4-class step (the
head's F = 4 kernels, image-layout logits) with kernels on against off,
``grad_accum=2`` (equal and ragged micro-batches) against the full batch,
and a tiny ``fit`` whose eval forwards launch no backward kernel.  Data:
augmentation on the card (TF32 switched on around it, which it must not
use) within 1e-5 of float64 from the same draws and against the gather
oracle, nearest masks exact; the augmented step's launches, the
unaugmented step's; ``CheckpointStore.restore`` onto the card, the next step
bit for bit; ``DataLoader`` through ``device_prefetch``.  The UNet family,
which launches no kernel of the port: a training step (SimAM on and off, 1
and 4 classes, ``grad_accum=2`` over a ragged batch) on the card against the
CPU, in float32 and in float64; the eval step and ``Server`` after a step;
and a resumed ``fit`` on the card bit for bit, running statistics included.
"""

import copy
import ctypes
import math
import subprocess

import pytest
import torch

from cswin_simam_unet_tpu_torch import _build
from cswin_simam_unet_tpu_torch.configs import TRAIN_CONFIGS, build_model
from cswin_simam_unet_tpu_torch.models import CSWinUNet, UNet
from cswin_simam_unet_tpu_torch.models.layers import FusedLayerNorm, FusedSimAMHead, LePEAttention
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


def _check_own(got, want, dtype):
    """An output against its own scale: the tolerance times max|plain|, with
    no floor at 1, for outputs (dq, dk, dv) that stay far below 1, where
    the floor would pass a gradient off by half."""
    err = float((got.float() - want.float()).abs().max())
    top = float(want.abs().max())
    assert top > 0.0
    tol = (TOL_F32 if dtype == torch.float32 else TOL_BF16) * top
    assert err <= tol, (err, tol)


def _ka_bwd(q, k, v, lk, g, **kw):
    """K-A' as the autograd Function runs it: from the L that K-A saves (the
    tensor-core body reads it; the CUDA-core body's K-A saves none)."""
    _, lse = stripe_attention.attention_fwd(q, k, v, lk, **kw, with_lse=True)
    return stripe_attention.attention_bwd(q, k, v, lk, g, **kw, lse=lse)


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


# (B, H, W, C, S) of the decoder's CARAFE kernels, K-C and K-C': small maps,
# the flagship's three decoder CARAFEs at batch 1 (64^2 C 64, 32^2 C 128,
# 16^2 C 256), S 4 at C 64 (the head path above 8 classes), a ragged 45 x 77
# map (W not a multiple of the 8-column strips of K-C', chunks that do not
# divide it), a single row, W = 1, C 6 (scalar slots) and C 24 (three bf16
# channel vectors)
CARAFE_GEOMS = [(2, 8, 8, 16, 2), (2, 6, 10, 8, 4), (2, 5, 7, 6, 2), (1, 64, 64, 64, 2),
                (1, 32, 32, 128, 2), (1, 16, 16, 256, 2), (1, 64, 64, 64, 4),
                (1, 45, 77, 64, 2), (2, 1, 37, 16, 2), (2, 9, 1, 16, 4), (2, 7, 9, 6, 4),
                (2, 9, 13, 24, 2)]


def _carafe_inputs(dev, dtype, B, H, W, C, S):
    return (_randn(dev, B, H, W, C).to(dtype), _randn(dev, B, H, W, 9 * S * S, seed=1).to(dtype),
            _randn(dev, B, H, W, S * S * C, seed=2).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,S", CARAFE_GEOMS)
def test_carafe_kernel(dev, dtype, B, H, W, C, S):
    """K-C against the plain version, each bf16 output also at its own scale."""
    x, enc, _ = _carafe_inputs(dev, dtype, B, H, W, C, S)
    _build.reset_launches()
    got = carafe_kernels.carafe_flat(x, enc, S)
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {carafe_kernels.KERNEL: 1}
    assert got.dtype == dtype
    _check_both(got, carafe.carafe_flat(x.float(), enc.float(), S), dtype)


def test_carafe_kernel_rejects_strided(dev):
    x = torch.zeros(1, 4, 8, 8, device=dev)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        carafe_kernels.carafe_flat(x, torch.zeros(1, 4, 4, 36, device=dev), 2)


def test_carafe_kernels_reject_what_cannot_fit(dev):
    """K-C's block (K-H1's) needs the two pass buffers of a pixel's 9*S^2
    taps in shared memory (S 32 does not fit; its channel vectors no longer
    bound it), and K-C' (on K4's body) takes at most 1024 (sub-pixel,
    channel vector) slots a pixel.  Both raise; nothing falls back."""
    x = torch.zeros(1, 2, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K-H1"):
        carafe_kernels.carafe_flat(x, torch.zeros(1, 2, 2, 9 * 32 * 32, device=dev,
                                                  dtype=torch.bfloat16), 32)
    x = torch.zeros(1, 2, 2, 4096, device=dev, dtype=torch.bfloat16)
    enc = torch.zeros(1, 2, 2, 36, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="threads"):
        carafe_kernels.carafe_flat_bwd(x, enc, torch.zeros(1, 2, 2, 4 * 4096, device=dev,
                                                           dtype=torch.bfloat16), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,S", [(1, 5, 7, 4096, 1), (1, 4, 9, 2560, 2)])
def test_carafe_kernel_wide(dev, dtype, B, H, W, C, S):
    """K-C above 256 channel vectors a pixel (JAX's CARAFE takes any C): one
    pixel a pass, the vectors in slices over blockIdx.y; against the plain
    version at both scales."""
    x, enc, _ = _carafe_inputs(dev, dtype, B, H, W, C, S)
    _build.reset_launches()
    got = carafe_kernels.carafe_flat(x, enc, S)
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {carafe_kernels.KERNEL: 1}
    want = carafe.carafe_flat(x.float(), enc.float(), S)
    _check_both(got, want, dtype)
    _check_own(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_carafe_kernels_deterministic(dev, dtype):
    """Two calls of K-C and of K-C' give bitwise equal outputs (no atomics),
    over ragged chunks, runs and strips."""
    x, enc, dout = _carafe_inputs(dev, dtype, 2, 45, 77, 64, 2)
    assert torch.equal(carafe_kernels.carafe_flat(x, enc, 2),
                       carafe_kernels.carafe_flat(x, enc, 2))
    for a, b in zip(carafe_kernels.carafe_flat_bwd(x, enc, dout, 2),
                    carafe_kernels.carafe_flat_bwd(x, enc, dout, 2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", range(9))
def test_carafe_kernels_one_hot_taps(dev, dtype, k):
    """Tap k's logit 30 above the others at every pixel and sub-pixel: p_k
    rounds to 1 and the other taps weigh e^-30, so out is x shifted by
    offset k alone (zero past the border), dx the cotangent gathered from
    that neighbour alone, and denc the other taps' p (dp - dp_k): K-C and
    K-C' against the plain versions, each output at its own scale too."""
    B, H, W, C, S = 2, 9, 13, 16, 2
    x, _, dout = _carafe_inputs(dev, dtype, B, H, W, C, S)
    enc = torch.full((B, H, W, 9, S * S), -30.0, device=dev)
    enc[..., k, :] = 0.0
    enc = enc.reshape(B, H, W, 9 * S * S).to(dtype)
    out = carafe_kernels.carafe_flat(x, enc, S)
    dy, dx = k // 3 - 1, k % 3 - 1
    shifted = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))[
        :, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    _check(out.reshape(B, H, W, S * S, C), shifted[..., None, :].expand(-1, -1, -1, S * S, -1),
           dtype)
    want = carafe.carafe_flat(x.float(), enc.float(), S)
    _check_both(out, want, dtype)
    _check_own(out, want, dtype)
    got = carafe_kernels.carafe_flat_bwd(x, enc, dout, S)
    want = carafe.carafe_bwd_reference(x.float(), enc.float(), dout.float(), S)
    for a, b in zip(got, want):
        _check_both(a, b, dtype)
        _check_own(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,S", [(2, 45, 77, 64, 2), (1, 16, 16, 256, 2),
                                       (2, 7, 9, 6, 4)])
def test_carafe_kernel_is_head_fwd_without_bias(dev, dtype, B, H, W, C, S):
    """K-C is K-H1's body without the bias: it equals K-H1 with a zero bias
    bit for bit (one rounding of the same float32 sum, then + 0)."""
    x, enc, _ = _carafe_inputs(dev, dtype, B, H, W, C, S)
    fb = carafe_head.carafe_biased_moments(x, enc, torch.zeros(C, device=dev), S, gate=False)[0]
    assert torch.equal(carafe_kernels.carafe_flat(x, enc, S), fb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("H,W,C,S,F", [(8, 8, 16, 4, 1), (4, 6, 8, 2, 3), (4, 4, 6, 2, 8),
                                       (8, 8, 16, 4, 4)])
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
    """K-H1's moments: per-block sums per real channel, (B, chunks, C),
    pooled with groups=1, against the statistics of the kernel's own map."""
    x = _randn(dev, 2, 8, 8, 16)
    enc = _randn(dev, 2, 8, 8, 144, seed=1)
    fb, s1, s2 = carafe_head.carafe_biased_moments(x, enc, torch.zeros(16, device=dev), 4)
    G = 16
    geom = carafe_head.h1_geometry(2, 8, 8, 16, 4, 4, carafe_head._sms(dev))
    assert s1.shape == s2.shape == (2, geom["chunks"], 16)
    mu, v = pooled_stats(s1.sum(1), s2.sum(1), 8 * 8 * G, 1)
    mu_p, v_p = pooled_stats(fb.sum((1, 2)), (fb * fb).sum((1, 2)), 8 * 8 * G, G)
    torch.testing.assert_close(mu, mu_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v, v_p, rtol=1e-5, atol=1e-6)
    assert carafe_head.carafe_biased_moments(x, enc, torch.zeros(16, device=dev), 4,
                                             gate=False)[1] is None


# (H, W, C, S, F) of the head's forward kernels: the 512^2 and 448^2 heads
# (batch 1), chunks that do not divide the image (45 x 77 = 3465 pixels),
# odd channel counts (C 24 in bf16: three channel vectors, the strided K-H2
# path; C 6: scalar slots; C 512: more channel vectors than a warp's lanes,
# and in bf16 a K-H1 pass of four pixels), S 2 and 4, 1, 3, 4 and 8 classes
# (4: cswin_simam_512_dp's head)
HEAD_FWD_GEOMS = [(128, 128, 64, 4, 1), (112, 112, 64, 4, 3), (45, 77, 64, 4, 8),
                  (9, 13, 24, 2, 3), (5, 7, 6, 2, 1), (3, 5, 512, 2, 8), (16, 16, 64, 4, 4)]


def _head_fwd_inputs(dev, dtype, H, W, C, S, F, B=1):
    G = S * S
    return (_randn(dev, B, H, W, C).to(dtype), _randn(dev, B, H, W, 9 * G, seed=1).to(dtype),
            _randn(dev, C, scale=0.1, seed=2).to(dtype),
            _randn(dev, C, F, scale=C ** -0.5, seed=3).to(dtype))


def _stats(fb, G):
    f = fb.float()
    H, W = fb.shape[1:3]
    return pooled_stats(f.sum((1, 2)), (f * f).sum((1, 2)), H * W * G, G)


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,S,F", HEAD_FWD_GEOMS)
def test_head_fwd_kernels(dev, dtype, gate, H, W, C, S, F):
    """K-H1 (the biased map and its moments) and K-H2 (the logits) against
    their plain versions, each bf16 output also at its own scale."""
    G = S * S
    x, enc, b, w = _head_fwd_inputs(dev, dtype, H, W, C, S, F)
    _build.reset_launches()
    fb, s1, s2 = carafe_head.carafe_biased_moments(x, enc, b, S, gate)
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {carafe_head.MOMENTS_KERNEL: 1}
    want = carafe.carafe_flat(x.float(), enc.float(), S) + b.float().repeat(G)
    assert fb.dtype == dtype and fb.shape == want.shape
    _check_both(fb, want, dtype)
    mu, v = _stats(fb, G)
    if gate:
        got = pooled_stats(s1.sum(1), s2.sum(1), H * W * G, 1)
        for a, r in zip(got, (mu, v)):
            assert float(((a - r).abs() / (1.0 + r.abs())).max()) <= 1e-4
    else:
        assert s1 is None and s2 is None
    _build.reset_launches()
    out = carafe_head.simam_head_flat(fb, mu, v, w, G, gate=gate)
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {carafe_head.HEAD_KERNEL: 1}
    want = carafe_head.head_reference(fb.float(), torch.zeros(C, device=dev), w.float(), G,
                                      gate=gate)
    assert out.dtype == dtype and out.shape == (1, H, W, G * F)
    _check_both(out, want, dtype)


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_fwd_kernels_deterministic(dev, dtype, gate):
    """Two calls of K-H1 and of K-H2 give bitwise equal outputs (the moments
    summed in a fixed order, no atomics), over ragged chunks."""
    H, W, C, S, F = 45, 77, 64, 4, 3
    x, enc, b, w = _head_fwd_inputs(dev, dtype, H, W, C, S, F, B=2)
    first = carafe_head.carafe_biased_moments(x, enc, b, S, gate)
    second = carafe_head.carafe_biased_moments(x, enc, b, S, gate)
    for a, r in zip(first, second):
        assert (a is None and r is None) or torch.equal(a, r)
    mu, v = _stats(first[0], S * S)
    assert torch.equal(carafe_head.simam_head_flat(first[0], mu, v, w, S * S, gate=gate),
                       carafe_head.simam_head_flat(first[0], mu, v, w, S * S, gate=gate))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,G", [(16, 16), (24, 4), (6, 4)])
def test_head_fwd_gate_is_the_backward_gate(dev, dtype, C, G):
    """K-H2's gate is K3's, bit for bit: K-H2 with one-hot W columns gives
    round(x g) of every pixel at those channels; K3 with a one-hot dy at
    (pixel, g) gives dW[:, 0] = round(x g) at that pixel's channels.  Both
    sums add only zeros to the one term, so they must agree exactly."""
    H, W = 7, 9
    fb = _randn(dev, 2, H, W, G * C, seed=5).to(dtype)
    mu, v = _stats(fb, G)
    gated = torch.empty(2, H, W, G, C, dtype=dtype, device=dev)
    for c0 in range(0, C, 8):
        cols = list(range(c0, min(C, c0 + 8)))
        w = torch.zeros(C, len(cols), device=dev)
        w[cols, range(len(cols))] = 1.0
        out = carafe_head.simam_head_flat(fb, mu, v, w, G)
        gated[..., cols] = out.reshape(2, H, W, G, len(cols))
    for b, y, x, g in ((0, 0, 0, 0), (1, 3, 4, G - 1), (1, H - 1, W - 1, G // 2)):
        dy = torch.zeros(2, H, W, G, device=dev, dtype=dtype)
        dy[b, y, x, g] = 1.0
        _, _, dW = carafe_head.head_bwd1(fb, dy.reshape(2, H, W, G), mu, v,
                                         torch.zeros(C, 1, device=dev), G)
        assert torch.equal(dW[:, 0], gated[b, y, x, g].float()), (b, y, x, g)


def test_head_fwd_kernels_reject(dev):
    """Geometries a launch cannot hold raise; nothing falls back: K-H2's
    slices of groups past the grid's height (a prime G above 65535), K-H1's
    moments above 256 channel vectors."""
    fb = torch.zeros(1, 1, 1, 65537 * 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K-H2"):
        carafe_head.simam_head_flat(fb, None, None, torch.zeros(8, 1, device=dev), 65537,
                                    gate=False)
    x = torch.zeros(1, 2, 2, 4096, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K-H1"):
        carafe_head.carafe_biased_moments(x, torch.zeros(1, 2, 2, 36, device=dev,
                                                         dtype=torch.bfloat16),
                                          torch.zeros(4096, device=dev), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("G,C,F", [(512, 8, 1), (17 * 31, 16, 3)])
def test_head_fwd_kernel_many_groups(dev, dtype, gate, G, C, F):
    """K-H2 with more groups than a block holds (JAX's simam_head takes any
    G): slices of whole groups over blockIdx.y, against the plain version."""
    fb = _randn(dev, 1, 3, 5, G * C, seed=5).to(dtype)
    w = _randn(dev, C, F, scale=C ** -0.5, seed=3)
    mu, v = _stats(fb, G)
    _build.reset_launches()
    out = carafe_head.simam_head_flat(fb, mu, v, w, G, gate=gate)
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {carafe_head.HEAD_KERNEL: 1}
    want = carafe_head.head_reference(fb.float(), torch.zeros(C, device=dev), w.float(), G,
                                      gate=gate)
    _check_both(out, want, dtype)


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
    """K-A' against the plain version, every output: float32 absolute, bf16
    at max(1, max|plain|) and at each output's own max|plain| (dq, dk, dv
    stay far below 1); with the LePE and without it (zero taps: dv is then
    P^T dO alone, which the LePE's transpose would hide), at rates 0 and
    0.3."""
    hsp, wsp = stripe_geometry(H, split, idx)
    qkv = _randn(dev, 2, H * H, 3 * C, scale=0.5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(dtype)
    g = _randn(dev, 2, H * H, 2 * C, seed=2).to(dtype)[..., C:]  # strided cotangent
    for rate in (0.0, 0.3):
        for taps in (lk, torch.zeros_like(lk)):
            kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=rate, seed=29)
            _build.reset_launches()
            got = _ka_bwd(q, k, v, taps, g, **kw)
            assert _build.LAUNCHES[stripe_attention.BWD_KERNEL] == 1
            want = attention.stripe_attention_bwd_reference(q.float(), k.float(), v.float(),
                                                            taps.float(), g.float(), **kw)
            for a, b in zip(got, want):
                assert a.shape == b.shape and a.dtype == dtype
                _check(a, b, dtype)
                if dtype == torch.bfloat16:
                    _check_own(a, b, dtype)


def test_stripe_attention_bwd_kernel_rejects(dev):
    q = torch.zeros(1, 256, 128, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        stripe_attention.attention_bwd(q, q, q, torch.zeros(3, 3, 1, 128, device=dev), q,
                                       H=16, W=16, hsp=16, wsp=16, num_heads=2)
    with pytest.raises(ValueError, match="dout"):
        stripe_attention.attention_bwd(q, q, q, torch.zeros(3, 3, 1, 128, device=dev),
                                       q[..., :64], H=16, W=16, hsp=1, wsp=16, num_heads=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,S", CARAFE_GEOMS + [(2, 4, 20, 64, 2)])
def test_carafe_bwd_kernel(dev, dtype, B, H, W, C, S):
    """K-C' against the plain version, each bf16 output also at its own scale."""
    x, enc, dout = _carafe_inputs(dev, dtype, B, H, W, C, S)
    _build.reset_launches()
    got = carafe_kernels.carafe_flat_bwd(x, enc, dout, S)
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {carafe_kernels.BWD_KERNEL: 1}
    want = carafe.carafe_bwd_reference(x.float(), enc.float(), dout.float(), S)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype
        _check_both(a, b, dtype)


def test_carafe_bwd_kernel_rejects(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    with pytest.raises(ValueError, match="dout"):
        carafe_kernels.carafe_flat_bwd(x, torch.zeros(1, 4, 4, 36, device=dev),
                                       torch.zeros(1, 4, 4, 16, device=dev), 2)


# (H, W, C, S, F) of the head's backward kernels: odd channel counts (C 6:
# scalar slots; C 24 in bf16: three channel vectors a sub-pixel; C 512: more
# channel vectors than a warp's lanes, and in float32 more vector slots
# than a K4 block's threads), a single row, W below a strip, 1, 3, 4
# (cswin_simam_512_dp's head) and 8 classes, S 2 and 4
HEAD_BWD_GEOMS = [(8, 8, 16, 4, 1), (4, 6, 8, 2, 3), (4, 4, 6, 2, 8), (6, 20, 64, 4, 1),
                  (9, 13, 24, 2, 3), (1, 11, 16, 4, 8), (5, 6, 64, 4, 3), (3, 5, 512, 2, 1),
                  (5, 6, 64, 4, 4)]


def _k4_tiles(H, W, C, S, F, dtype):
    """K4 blocks (rows, px) that cross the image in every way: the default,
    one column a block, runs of H - 1 rows (H = rows + 1) and of 2 over
    strips of 8 (a single strip where W <= 8), runs of 4 over strips of 2;
    those whose block fits shared memory."""
    elem = torch.finfo(dtype).bits // 8
    vec = 16 // elem if C % (16 // elem) == 0 else 1
    return [None] + [t for t in [(2, 1), (max(1, H - 1), 8), (2, 8), (4, 2)]
                     if carafe_head.k4_smem_bytes(C, S, vec, elem, t[1], F, True)
                     <= carafe_head.SMEM_LIMIT]


def _head_bwd_inputs(dev, dtype, H, W, C, S, F, B=2):
    G = S * S
    x = _randn(dev, B, H, W, C).to(dtype)
    enc = _randn(dev, B, H, W, 9 * G, seed=1).to(dtype)
    fb = _randn(dev, B, H, W, G * C, seed=2).to(dtype)
    dy = _randn(dev, B, H, W, G * F, seed=3).to(dtype)
    w = _randn(dev, C, F, scale=C ** -0.5, seed=4)
    f = fb.float()
    mu, v = pooled_stats(f.sum((1, 2)), (f * f).sum((1, 2)), H * W * G, G)
    return x, enc, fb, dy, w, mu, v


def _check_both(got, want, dtype):
    """A head backward output: float32 within TOL_F32, bf16 within TOL_BF16
    times max(1, max|plain|) and times its own max|plain|."""
    _check(got, want, dtype)
    if dtype == torch.bfloat16:
        _check_own(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,S,F", HEAD_BWD_GEOMS)
def test_head_bwd_kernels(dev, dtype, H, W, C, S, F):
    """K3, then K4 at every tile of _k4_tiles, against the plain versions."""
    G = S * S
    x, enc, fb, dy, w, mu, v = _head_bwd_inputs(dev, dtype, H, W, C, S, F)
    f = fb.float()
    _build.reset_launches()
    got = carafe_head.head_bwd1(fb, dy, mu, v, w, G)
    assert _build.LAUNCHES[carafe_head.BWD1_KERNEL] == 1
    want = carafe_head.head_bwd1_reference(f, dy.float(), mu, v, w, G)
    for a, b in zip(got, want):
        _check_both(a, b, dtype)
    A, Bq = want[0], want[1]
    want = carafe_head.fused_head_bwd_reference(x.float(), enc.float(), f, dy.float(), mu,
                                                v, A, Bq, w, S)
    for tile in _k4_tiles(H, W, C, S, F, dtype):
        _build.reset_launches()
        got = carafe_head.fused_head_bwd(x, enc, fb, dy, mu, v, A, Bq, w, S, tile=tile)
        assert _build.LAUNCHES[carafe_head.FUSED_BWD_KERNEL] == 1
        assert got[0].dtype == dtype and got[1].dtype == dtype and got[2].shape == (C,)
        for a, b in zip(got, want):
            _check_both(a, b, dtype)


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_bwd_kernels_deterministic(dev, dtype, gate):
    """Two calls of K3 and of K4 give bitwise equal outputs (no float
    atomics; partial sums in a fixed order), at a geometry with several runs
    and strips and ragged ends."""
    H, W, C, S, F = 19, 21, 64, 4, 3
    x, enc, fb, dy, w, mu, v = _head_bwd_inputs(dev, dtype, H, W, C, S, F)
    if not gate:
        mu = v = None
    first = carafe_head.head_bwd1(fb, dy, mu, v, w, S * S, gate=gate)
    second = carafe_head.head_bwd1(fb, dy, mu, v, w, S * S, gate=gate)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)
    A, Bq = first[0], first[1]
    for tile in (None, (4, 8)):
        first = carafe_head.fused_head_bwd(x, enc, fb, dy, mu, v, A, Bq, w, S, gate=gate,
                                           tile=tile)
        second = carafe_head.fused_head_bwd(x, enc, fb, dy, mu, v, A, Bq, w, S, gate=gate,
                                            tile=tile)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


_DIVISION_CHECK = r"""
#include "common.cuh"
__global__ void division_check(const float* a, const float* b, float* fast, float* ref,
                               int n, int rcp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fast[i] = rcp ? csu::rcp_rn(b[i]) : csu::div_rn(a[i], b[i]);
  ref[i] = rcp ? 1.f / b[i] : a[i] / b[i];
}
extern "C" int run_division_check(const float* a, const float* b, float* fast, float* ref,
                                  int n, int rcp) {
  division_check<<<(n + 255) / 256, 256>>>(a, b, fast, ref, n, rcp);
  return (int)cudaDeviceSynchronize();
}
"""


def test_branch_free_division_rounds_as_division(dev, tmp_path):
    """K3's gate takes rcp_rn and div_rn (common.cuh) where K-H2 divides, and
    must round x * g as K-H2 does: both must give what / gives, bit for bit.
    rcp_rn over every float in [1, 2) (every normal mantissa; the gate's
    1 + exp(-e) lies in [1, 1.61]); div_rn over 2^24 quotients whose operands
    spread over 2^+-60 and 2^+-20, zeros among them, and over the gate's own
    range (xc^2 over 4 (v + lam))."""
    src = tmp_path / "division_check.cu"
    src.write_text(_DIVISION_CHECK)
    lib_path = tmp_path / "libdivision_check.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build._CSRC),
                    "-o", str(lib_path), str(src)], check=True, capture_output=True,
                   timeout=_build.NVCC_TIMEOUT_S)
    lib = ctypes.CDLL(str(lib_path))
    lib.run_division_check.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int]

    def run(a, b, rcp):
        fast, ref = torch.empty_like(b), torch.empty_like(b)
        assert lib.run_division_check(a.data_ptr(), b.data_ptr(), fast.data_ptr(),
                                      ref.data_ptr(), b.numel(), rcp) == 0
        bad = int((fast.view(torch.int32) != ref.view(torch.int32)).sum())
        assert bad == 0, (bad, b.numel())

    mantissas = torch.arange(0x3F800000, 0x40000000, dtype=torch.int32, device=dev)
    x = mantissas.view(torch.float32)
    run(x, x, 1)
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1 << 24

    def spread(lo, hi):
        m = 1.0 + torch.rand(n, generator=g, device=dev)
        return torch.ldexp(m, torch.randint(lo, hi, (n,), generator=g, device=dev))

    a = spread(-60, 60)
    a[::97] = 0.0
    run(a, spread(-20, 20), 0)
    xc = torch.randn(n, generator=g, device=dev) * 3.0
    v = torch.rand(n, generator=g, device=dev) * 4.0
    run(xc * xc, 4.0 * (v + 1e-4), 0)


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
@pytest.mark.parametrize("H,W,C,S,F", HEAD_BWD_GEOMS)
def test_head_bwd_nogate_kernels(dev, dtype, H, W, C, S, F):
    """K3 and K4 without the gate, K4 at every tile of _k4_tiles."""
    G = S * S
    x, enc, fb, dy, w, _, _ = _head_bwd_inputs(dev, dtype, H, W, C, S, F)
    _build.reset_launches()
    got = carafe_head.head_bwd1(fb, dy, None, None, w, G, gate=False)
    assert _build.LAUNCHES[carafe_head.BWD1_NOGATE_KERNEL] == 1
    want = carafe_head.head_bwd1_reference(fb.float(), dy.float(), None, None, w, G,
                                           gate=False)
    assert got[0] is None and got[1] is None
    _check_both(got[2], want[2], dtype)
    want = carafe_head.fused_head_bwd_reference(x.float(), enc.float(), fb.float(),
                                                dy.float(), None, None, None, None, w, S,
                                                gate=False)
    for tile in _k4_tiles(H, W, C, S, F, dtype):
        _build.reset_launches()
        got = carafe_head.fused_head_bwd(x, enc, fb, dy, None, None, None, None, w, S,
                                         gate=False, tile=tile)
        assert _build.LAUNCHES[carafe_head.FUSED_BWD_NOGATE_KERNEL] == 1
        assert got[0].dtype == dtype and got[1].dtype == dtype and got[2].shape == (C,)
        for a, b in zip(got, want):
            _check_both(a, b, dtype)


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
    got = _ka_bwd(q, k, v, lk, g, **kw)
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



# H-slabs of 2 shards: (H global, W, hsp, C, heads); 256 tokens a window
# (whole-window K-A / K-A') and 512 (the tiled pair)
OFFSET_GEOMS = [(128, 128, 2, 64, 2), (64, 512, 1, 64, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,hsp,C,heads", OFFSET_GEOMS)
def test_attention_dropout_window_offset(dev, dtype, H, W, hsp, C, heads):
    """K-A and K-A' (or the tiled pair) on each H-slab of 2 shards, the
    mask keyed on the slab's windows in the whole image (``win0``,
    ``nwin_global``), against the plain versions at the same numbering and
    against the slab's rows of the plain whole-image forward; the defaults
    draw the mask of windows 0 .. n - 1, as before."""
    B, n = 2, 2
    Hl = H // n
    nwin = Hl // hsp  # full-width stripes
    q, k, v = (_randn(dev, B, H * W, C, scale=0.5, seed=i).to(dtype) for i in range(3))
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=3).to(dtype)
    g = _randn(dev, B, H * W, C, seed=4).to(dtype)
    kw = dict(W=W, hsp=hsp, wsp=W, num_heads=heads, attn_drop=0.3, seed=2 ** 31 + 11)
    whole = attention.stripe_attention(*(t.float() for t in (q, k, v, lk)), H=H, **kw)
    tiled = not stripe_attention.whole_window(hsp * W, C // heads)
    for r in range(n):
        rows = slice(r * Hl * W, (r + 1) * Hl * W)
        sl = [t[:, rows].contiguous() for t in (q, k, v, g)]
        at = dict(kw, H=Hl, win0=r * nwin, nwin_global=n * nwin)
        _build.reset_launches()
        if tiled:
            out, lse = stripe_attention.tiled_fwd(*sl[:3], lk, **at)
            grads = stripe_attention.tiled_bwd(*sl[:3], lk, lse, sl[3], **at)
        else:
            out = stripe_attention.attention_fwd(*sl[:3], lk, **at)
            grads = _ka_bwd(*sl[:3], lk, sl[3], **at)
        assert sum(_build.LAUNCHES.values()) >= 2
        f32 = [t.float() for t in sl]
        _check(out, attention.stripe_attention(*f32[:3], lk.float(), **at), dtype)
        _check(out, whole[:, rows], dtype)
        want = attention.stripe_attention_bwd_reference(*f32[:3], lk.float(), f32[3], **at)
        for a, b in zip(grads, want):
            _check_scaled(a, b, dtype)
        if r == 1:  # another numbering draws other bits
            at0 = dict(at, win0=0, nwin_global=None)
            plain0 = attention.stripe_attention(*f32[:3], lk.float(), **at0)
            assert float((plain0 - out.float()).abs().max()) > 1e-2
    m = dropout.window_keep_mask(7, 6, 2, 16, dropout.u32_threshold(0.3))
    assert torch.equal(m, dropout.window_keep_mask(7, 6, 2, 16, dropout.u32_threshold(0.3),
                                                   nwin=3, win0=0, nwin_global=3))


# a layer's heads split over 2 ranks: (H, W, hsp, C, heads), full-width
# stripes; 256 tokens a window (whole-window K-A / K-A') and 512 (the tiled pair)
HEAD_OFFSET_GEOMS = [(32, 128, 2, 128, 4), (16, 512, 1, 128, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,hsp,C,heads", HEAD_OFFSET_GEOMS)
def test_attention_dropout_head_offset(dev, dtype, H, W, hsp, C, heads):
    """K-A and K-A' (or the tiled pair) on heads [h0, h0 + n) of a layer (a
    rank's own heads under tensor parallelism), their channels read in place
    from one qkv projection, the mask keyed on the layer's head numbers
    (``head0``), against the plain versions at the same ``head0`` and
    against those heads' channels of the plain call on every head; head0 0
    draws the mask of heads 0 .. n - 1, as before."""
    B, n, d = 2, heads // 2, C // heads
    qkv = _randn(dev, B, H * W, 3 * C, scale=0.5, seed=5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=6).to(dtype)
    g = _randn(dev, B, H * W, C, seed=7).to(dtype)
    kw = dict(H=H, W=W, hsp=hsp, wsp=W, attn_drop=0.3, seed=2 ** 31 + 13)
    f32 = [t.float() for t in (q, k, v, lk, g)]
    whole = attention.stripe_attention(*f32[:4], num_heads=heads, **kw)
    whole_grads = attention.stripe_attention_bwd_reference(*f32, num_heads=heads, **kw)
    tiled = not stripe_attention.whole_window(hsp * W, d)
    for h0 in (0, n):
        ch = slice(h0 * d, (h0 + n) * d)
        sl = [t[..., ch] for t in (q, k, v, lk)] + [g[..., ch].contiguous()]
        at = dict(kw, num_heads=n, head0=h0)
        _build.reset_launches()
        if tiled:
            out, lse = stripe_attention.tiled_fwd(*sl[:4], **at)
            grads = stripe_attention.tiled_bwd(*sl[:4], lse, sl[4], **at)
        else:
            out = stripe_attention.attention_fwd(*sl[:4], **at)
            grads = _ka_bwd(*sl, **at)
        assert sum(_build.LAUNCHES.values()) >= 2
        ref = [t.float() for t in sl]
        _check(out, attention.stripe_attention(*ref[:4], **at), dtype)
        _check(out, whole[..., ch], dtype)
        want = attention.stripe_attention_bwd_reference(*ref, **at)
        for got, one, full in zip(grads, want, whole_grads):
            _check_scaled(got, one, dtype)
            _check_scaled(got, full[..., ch], dtype)
        if h0:  # another numbering draws other bits
            plain0 = attention.stripe_attention(*ref[:4], **dict(at, head0=0))
            assert float((plain0 - out.float()).abs().max()) > 1e-2
    assert tiled == (hsp * W > 256)  # both families are held

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


# ---- the multi-class step, gradient accumulation and fit ----

CLASSES = 4
# one tiny forward's launches (14 attention branches, 3 decoder CARAFEs, the
# head) and the backward's on top of them in a training step
TINY_FORWARD = {stripe_attention.KERNEL: 14, carafe_kernels.KERNEL: 3,
                carafe_head.MOMENTS_KERNEL: 1, carafe_head.HEAD_KERNEL: 1}
TINY_STEP = {**TINY_FORWARD, stripe_attention.BWD_KERNEL: 14, carafe_kernels.BWD_KERNEL: 3,
             carafe_head.BWD1_KERNEL: 1, carafe_head.FUSED_BWD_KERNEL: 1}


def _uint8_batch(B, seed, n_classes):
    """Random uint8 images and masks: class ids, or 0/255 for one class."""
    gen = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (B, 64, 64, 3), generator=gen, dtype=torch.uint8)
    masks = torch.randint(0, max(n_classes, 2), (B, 64, 64, 1), generator=gen)
    return images, (masks if n_classes > 1 else masks * 255).to(torch.uint8)


def _launched():
    return {k: n for k, n in _build.LAUNCHES.items() if n}


def test_multiclass_step_kernels_match_plain(dev):
    """The 4-class step at drops 0.3, one seed: image-layout logits through
    the head's F = 4 kernels, float32 gradients with kernels on against off."""
    model = CSWinUNet(**TINY, num_classes=CLASSES, use_simam=True, drop_rate=0.3,
                      attn_drop_rate=0.3, drop_path_rate=0.3, device=dev, seed=8)
    images, masks = _uint8_batch(2, 2, CLASSES)
    runs = []
    for use_kernels in (True, False):
        model.zero_grad(set_to_none=True)
        _build.reset_launches()
        loss, logits, targets = engine.compute_gradients(model, images, masks, CLASSES,
                                                         use_kernels, rng=19)
        runs.append((float(loss), {n: p.grad.clone() for n, p in model.named_parameters()},
                     _launched()))
    assert tuple(logits.shape) == (2, 64, 64, CLASSES) and targets.dtype == torch.int64
    assert runs[0][2] == TINY_STEP and runs[1][2] == {}
    assert abs(runs[0][0] - runs[1][0]) <= 1e-4
    for name, g in runs[1][1].items():
        err = float((runs[0][1][name] - g).abs().max())
        assert err <= 1e-3 * max(float(g.abs().max()), 1e-12), (name, err)


@pytest.mark.parametrize("n_classes", [1, CLASSES])
@pytest.mark.parametrize("batch", [4, 3], ids=["equal", "ragged"])
def test_grad_accum_matches_full_batch_on_card(dev, n_classes, batch):
    """grad_accum=2 against the full-batch step from the same weights (AdamW
    at lr 0 keeps them): gradients within 1e-3 x max|g|, loss, Dice and IoU
    within 1e-5 relative, twice a step's launches."""
    model = CSWinUNet(**TINY, num_classes=n_classes, use_simam=True, device=dev, seed=9)
    opt = engine.make_optimizer("adamw", 0.0, 0.0, model.parameters())
    images, masks = _uint8_batch(batch, 3, n_classes)
    runs = []
    for accum in (1, 2):
        _build.reset_launches()
        m = engine.make_train_step(model, opt, n_classes, grad_accum=accum)(images, masks)
        runs.append(({k: float(v) for k, v in m.items()},
                     {n: p.grad.clone() for n, p in model.named_parameters()}, _launched()))
    (full, g_full, c_full), (acc, g_acc, c_acc) = runs
    assert c_full == TINY_STEP and c_acc == {k: 2 * n for k, n in TINY_STEP.items()}
    for k in engine.METRICS:
        assert abs(acc[k] - full[k]) <= 1e-5 * max(abs(full[k]), 1e-30), (k, acc[k], full[k])
    for name, g in g_full.items():
        err = float((g_acc[name] - g).abs().max())
        assert err <= 1e-3 * max(float(g.abs().max()), 1e-12), (name, err)


def test_fit_on_card(dev):
    """A tiny 4-class ``fit`` from host uint8 batches: an eval forward
    launches the forward kernels only (no backward kernel), a training step
    a step's; over 2 epochs of 2 steps and 1 eval forward the counts add up
    to exactly that, and the history is 7 finite series."""
    model = CSWinUNet(**TINY, num_classes=CLASSES, use_simam=True, device=dev, seed=10)
    opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
    train = [tuple(t.numpy() for t in _uint8_batch(2, s, CLASSES)) for s in (4, 5)]
    test = [tuple(t.numpy() for t in _uint8_batch(2, 6, CLASSES))]
    _build.reset_launches()
    engine.evaluate(engine.make_eval_step(model, CLASSES), test, dev)
    assert _launched() == TINY_FORWARD
    _build.reset_launches()
    history, step = engine.fit(model, opt, train, test, engine.FitConfig(
        num_epochs=2, n_classes=CLASSES, augment=None, plateau_patience=0, verbose=False))
    assert step == 4
    assert _launched() == {k: 4 * TINY_STEP[k] + 2 * TINY_FORWARD.get(k, 0) for k in TINY_STEP}
    assert all(len(v) == 2 and all(map(math.isfinite, v)) for v in history.values())


# ---- data: augmentation on the card, checkpoints, the loader ----

@pytest.mark.parametrize("nearest", [False, True], ids=["bilinear", "nearest"])
@pytest.mark.parametrize("N,B", [(64, 4), (512, 2)])
def test_augmentation_on_card(dev, N, B, nearest):
    """The matrix form on the card, TF32 allowed globally (it must not be
    used): within 1e-5 of float64 on the CPU from the same draws, nearest
    class-id masks exact, and against the gather oracle; every k and flip
    forced on the first samples."""
    from cswin_simam_unet_tpu_torch.data import augment
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cfg = augment.AugmentConfig(mask_nearest=nearest)
        gen = torch.Generator(device=dev).manual_seed(N + B)
        images = torch.rand(B, N, N, 3, generator=gen, device=dev)
        masks = torch.randint(0, CLASSES, (B, N, N, 1), generator=gen, device=dev).float()
        if not nearest:
            masks = (masks > 1).float()
        draws = list(augment.draw_params(gen, B, cfg))
        draws[0][0], draws[1][0], draws[2][0] = True, False, 1
        draws[0][1], draws[1][1], draws[2][1] = False, True, 3
        got = augment.augment_from_params(images, masks, *draws, cfg=cfg)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = augment.augment_from_params(images.cpu().double(), masks.cpu().double(),
                                      *[d.cpu() for d in draws], cfg=cfg)
    gather = augment.augment_gather(images, masks, *draws, cfg=cfg)
    assert float((got[0].cpu().double() - ref[0]).abs().max()) <= 1e-5
    assert float((got[0] - gather[0]).abs().max()) <= 1e-5
    if nearest:
        assert torch.equal(got[1].cpu().double(), ref[1]) and torch.equal(got[1], gather[1])
    else:
        assert float((got[1].cpu().double() - ref[1]).abs().max()) <= 1e-5


def test_augmented_step_launches_the_unaugmented_steps_kernels(dev):
    from cswin_simam_unet_tpu_torch.data import AugmentConfig
    for n_classes in (1, CLASSES):
        model = CSWinUNet(**TINY, num_classes=n_classes, use_simam=True, device=dev, seed=11)
        opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
        images, masks = _uint8_batch(2, 7, n_classes)
        for aug in (None, AugmentConfig(mask_nearest=n_classes > 1)):
            _build.reset_launches()
            m = engine.make_train_step(model, opt, n_classes, augment=aug)(images, masks, rng=3)
            torch.cuda.synchronize()
            assert _launched() == TINY_STEP, (n_classes, aug)
            assert math.isfinite(float(m["loss"])) and 0.0 <= float(m["dice"]) <= 1.0


def test_checkpoint_restore_onto_the_card(dev, tmp_path, monkeypatch):
    """Save a trained model's and AdamW's state on the card; restore into a
    fresh model and optimizer on the card: equal, the moments on the card,
    the step count on the host; the next step equal bit for bit with cuDNN's
    deterministic algorithms (its default float32 convolution backward
    differs by about 1e-9 between two calls on the same inputs)."""
    from cswin_simam_unet_tpu_torch.train.checkpoint import CheckpointStore
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    models, opts = [], []
    for seed in (12, 13):
        models.append(CSWinUNet(**TINY, use_simam=True, device=dev, seed=seed))
        opts.append(engine.make_optimizer("adamw", 1e-3, 1e-4, models[-1].parameters()))
    images, masks = _uint8_batch(2, 8, 1)
    engine.make_train_step(models[0], opts[0])(images, masks, rng=1)
    store = CheckpointStore(str(tmp_path))
    store.save_epoch(1, models[0], opts[0], None, {"x": [1.0]}, 0.5, global_step=1)
    _, history, epoch, step = store.restore(models[1], opts[1])
    assert (history, epoch, step) == ({"x": [1.0]}, 1, 1)
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert b.device.type == "cuda" and torch.equal(a, b)
    for was, state in zip(opts[0].state.values(), opts[1].state.values()):
        assert state["exp_avg"].device.type == "cuda" and state["step"].device.type == "cpu"
        assert all(torch.equal(was[k], state[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    for model, opt in zip(models, opts):
        engine.make_train_step(model, opt)(images, masks, rng=2)
    assert all(torch.equal(a, b) for a, b in zip(models[0].parameters(), models[1].parameters()))


def test_loader_to_card(dev):
    """DataLoader batches through device_prefetch: on the card, in order,
    equal to the host batches."""
    from cswin_simam_unet_tpu_torch.data import DataLoader, device_prefetch

    class Memory:
        def __init__(self):
            gen = torch.Generator().manual_seed(14)
            self.x = torch.randint(0, 256, (7, 16, 16, 3), generator=gen,
                                   dtype=torch.uint8).numpy()

        def __len__(self):
            return 7

        def load(self, i):
            return self.x[i], self.x[i, ..., :1]

        def load_batch(self, idx):
            return None

    loader = DataLoader(Memory(), batch_size=3, shuffle=True, seed=1, num_workers=2)
    host = list(loader)
    loader.set_epoch(0)
    on_card = list(device_prefetch(loader, dev))
    assert len(on_card) == len(host) == 3
    for (a, b), (x, y) in zip(on_card, host):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), torch.from_numpy(x))
        assert torch.equal(b.cpu(), torch.from_numpy(y))


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
    mask for mask, every output; the backward also without the LePE (zero
    taps, dv = P^T dO alone), bf16 also at each output's own scale."""
    q, k, v, lk, g = _long_inputs(dev, dtype, H, C)
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=rate, seed=2 ** 31 + 9)
    f32 = [t.float() for t in (q, k, v, lk, g)]
    for taps in (lk, torch.zeros_like(lk)):
        _build.reset_launches()
        out, lse = stripe_attention.tiled_fwd(q, k, v, taps, **kw)
        got = stripe_attention.tiled_bwd(q, k, v, taps, lse, g, **kw)
        assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
            stripe_attention.TILED_KERNEL: 1,
            **{n: 1 for n in stripe_attention.TILED_BWD_KERNELS}}
        _check(out, attention.stripe_attention(*f32[:3], taps.float(), **kw), dtype)
        want = attention.stripe_attention_bwd_reference(*f32[:3], taps.float(), f32[4], **kw)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == dtype
            _check_scaled(a, b, dtype)
            if dtype == torch.bfloat16:
                _check_own(a, b, dtype)


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
    want = _ka_bwd(q, k, v, lk, g, **kw)
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


# ---- the flash family's bf16 tensor-core backward bodies (dq, dk/dv) ----

# (H, W, hsp, wsp, C, heads): windows of 400 and 520 tokens (not multiples of
# the 64-row tiles; the 520-token flash mask tiles of pick_tile(520) = 104
# do not divide them), a 7 x 64 window, vertical stripes, head dims 16, 32
# and 64, and a window of fewer tokens than one tile
MMA_GEOMS = [(20, 20, 20, 20, 32, 1), (20, 26, 20, 26, 32, 1), (14, 64, 7, 64, 32, 2),
             (64, 64, 64, 8, 32, 1), (32, 32, 16, 32, 128, 2), (16, 16, 16, 16, 64, 4),
             (8, 8, 8, 4, 16, 1)]


BWD_ENTRIES = (flash_attention.DQ_KERNEL, flash_attention.DKV_KERNEL)


def _flash_mode_bwd(q, k, v, g, kw, f32):
    """Flash mode's dq, dk, dv from the plain forward's O and L, and the
    plain version's, on the bands of full-width windows."""
    N, C, heads = kw["hsp"] * kw["wsp"], q.shape[-1], kw["num_heads"]
    ref_kw = dict(heads=heads, attn_drop=kw["attn_drop"], seed=kw["seed"])
    bands = [t.reshape(-1, N, C) for t in (f32[0], f32[1], f32[2], f32[4])]
    out_ref, lse_ref = flash_attention.flash_attention_reference(*bands[:3], **ref_kw)
    o = out_ref.to(q.dtype)
    delta = flash_attention.flash_delta(o, g.reshape(-1, N, C), heads)
    got = flash_attention.kernel_bwd(q, k, v, None, lse_ref, g, **kw, delta=delta,
                                     mode="flash")
    want = flash_attention.flash_attention_bwd_reference(*bands[:3], o.float(), lse_ref,
                                                         bands[3], **ref_kw)
    return [a.reshape(b.shape) for a, b in zip(got[:3], want)], want


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("H,W,hsp,wsp,C,heads", MMA_GEOMS)
def test_flash_bwd_tensor_core_bodies(dev, rate, H, W, hsp, wsp, C, heads):
    """The bf16 tensor-core dq and dk/dv against their plain versions, mask
    for mask, batch 2: window mode (the tiled K-A', delta computed by dq)
    and, where the windows span the width, flash mode (delta given); every
    launch takes the tensor-core body."""
    dtype = torch.bfloat16
    qkv = _randn(dev, 2, H * W, 3 * C, scale=0.5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(dtype)
    g = _randn(dev, 2, H * W, C, seed=2).to(dtype)
    kw = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=rate, seed=13)
    f32 = [t.float() for t in (q, k, v, lk, g)]
    _, lse = stripe_attention.tiled_fwd(q, k, v, lk, **kw)
    _build.reset_launches()
    for taps in (lk, torch.zeros_like(lk)):  # with the LePE, and dv = P^T dO alone
        got = stripe_attention.tiled_bwd(q, k, v, taps, lse, g, **kw)
        want = attention.stripe_attention_bwd_reference(*f32[:3], taps.float(), f32[4], **kw)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == dtype
            _check_scaled(a, b, dtype)
            _check_own(a, b, dtype)
    modes = ["window"]
    if wsp == W:
        modes.append("flash")
        for a, b in zip(*_flash_mode_bwd(q, k, v, g, kw, f32)):
            _check_scaled(a, b, dtype)
            _check_own(a, b, dtype)
    assert {n: c for n, c in _build.BODY_LAUNCHES.items() if c} == {
        f"{e}:{m}:mma": 1 + (m == "window") for e in BWD_ENTRIES for m in modes}


@pytest.mark.parametrize("dtype,C,heads,body", [
    (torch.bfloat16, 32, 1, "mma"), (torch.bfloat16, 32, 2, "mma"),
    (torch.bfloat16, 128, 2, "mma"), (torch.bfloat16, 16, 2, "fma"),
    (torch.float32, 32, 1, "fma"), (torch.float32, 128, 2, "fma")])
def test_flash_bwd_body_by_dtype_and_head_dim(dev, dtype, C, heads, body):
    """bf16 at head dims 16, 32 and 64 takes the tensor-core body; float32
    and head dim 8 the CUDA-core body, in both modes, each right."""
    H = 20
    qkv = _randn(dev, 2, H * H, 3 * C, scale=0.5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(dtype)
    g = _randn(dev, 2, H * H, C, seed=2).to(dtype)
    kw = dict(H=H, W=H, hsp=H, wsp=H, num_heads=heads, attn_drop=0.3, seed=21)
    f32 = [t.float() for t in (q, k, v, lk, g)]
    assert flash_attention.kernel_body(q, C // heads) == body
    _, lse = stripe_attention.tiled_fwd(q, k, v, lk, **kw)
    _build.reset_launches()
    got = stripe_attention.tiled_bwd(q, k, v, lk, lse, g, **kw)
    for a, b in zip(got, attention.stripe_attention_bwd_reference(*f32, **kw)):
        _check_scaled(a, b, dtype)
        _check_own(a, b, dtype)
    for a, b in zip(*_flash_mode_bwd(q, k, v, g, kw, f32)):
        _check_scaled(a, b, dtype)
        _check_own(a, b, dtype)
    assert {n: c for n, c in _build.BODY_LAUNCHES.items() if c} == {
        f"{e}:{m}:{body}": 1 for e in BWD_ENTRIES for m in ("window", "flash")}
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        f"{e}:{m}": 1 for e in BWD_ENTRIES for m in ("window", "flash")}


def test_flash_bwd_tensor_core_copies_unaligned_rows(dev):
    """q, k, v and dO whose base or row stride is not 16-byte aligned (column
    slices of a 3C + 1 wide tensor) reach the tensor-core body as explicit
    aligned copies: dq, dk, dv and dw equal those of contiguous inputs."""
    C, H = 32, 20
    wide = _randn(dev, 2, H * H, 3 * C + 1, scale=0.5).to(torch.bfloat16)
    q, k, v = wide[..., 1:C + 1], wide[..., C + 1:2 * C + 1], wide[..., 2 * C + 1:]
    g = _randn(dev, 2, H * H, C + 1, seed=2).to(torch.bfloat16)[..., 1:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(torch.bfloat16)
    kw = dict(H=H, W=H, hsp=H, wsp=H, num_heads=1, attn_drop=0.3, seed=5)
    _, lse = stripe_attention.tiled_fwd(q, k, v, lk, **kw)
    got = stripe_attention.tiled_bwd(q, k, v, lk, lse, g, **kw)
    want = stripe_attention.tiled_bwd(*(t.contiguous() for t in (q, k, v)), lk, lse,
                                      g.contiguous(), **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flash_bwd_tensor_core_tail_with_very_negative_lse(dev):
    """A 420-token window (not a multiple of the 16-key chunks) whose scores
    are all about -100, so L < -88: the zero-filled keys past N must give
    p = 0, not exp(-L) = inf (inf x 0 made NaN in delta and dq).  Held at
    the max(1, .) scale only: q and k share a large component, along which
    the bf16 rounding of ds (which the float32 plain version skips) sums
    without cancelling."""
    C, H, W = 32, 20, 21
    q = (4.2 + 0.1 * _randn(dev, 1, H * W, C)).to(torch.bfloat16)
    k = (-4.2 + 0.1 * _randn(dev, 1, H * W, C, seed=1)).to(torch.bfloat16)
    v = _randn(dev, 1, H * W, C, scale=0.5, seed=2).to(torch.bfloat16)
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=3).to(torch.bfloat16)
    g = _randn(dev, 1, H * W, C, seed=4).to(torch.bfloat16)
    kw = dict(H=H, W=W, hsp=H, wsp=W, num_heads=1, attn_drop=0.0, seed=0)
    _, lse = stripe_attention.tiled_fwd(q, k, v, lk, **kw)
    assert float(lse.max()) < -88.0
    got = stripe_attention.tiled_bwd(q, k, v, lk, lse, g, **kw)
    want = attention.stripe_attention_bwd_reference(
        *(t.float() for t in (q, k, v, lk, g)), **kw)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        _check_scaled(a, b, torch.bfloat16)


def test_model_2048_training_step_runs_tensor_core_bodies(dev):
    """A bf16 training step of CSWin-SimAM-UNet at 2048^2 launches the
    tensor-core forward, dq and dk/dv 48 times each as the tiled K-A / K-A'
    and twice each on the flash path, and the CUDA-core bodies never."""
    model = build_model("cswin_simam_2048", device=dev, seed=0)
    x = torch.rand(1, 2048, 2048, 3, device=dev)
    opt = engine.make_optimizer("adamw", 1e-4, 1e-4, model.parameters())
    step = engine.make_train_step(model, opt, seed=0)
    images = (x * 255).to(torch.uint8)
    masks = ((x[..., :1] > 0.5) * 255).to(torch.uint8)
    _build.reset_launches()
    out = step(images, masks)
    assert {n: c for n, c in _build.BODY_LAUNCHES.items() if c} == {
        f"{e}:{m}:mma": n for e in _build.FLASH_ENTRIES
        for m, n in (("window", 48), ("flash", 2))}
    assert all(bool(torch.isfinite(torch.as_tensor(val))) for val in out.values())


# ---- the attention forwards' bf16 tensor-core bodies: K-A and the flash
# forward (csrc/attention_fwd_mma.cuh) ----

# (H, W, hsp, wsp): K-A windows of 128 (1 x 128 and 128 x 1 stripes), 196
# (7 x 28, cswinunet's stage 3: tails of the 64-row tiles and 16-key
# chunks), 256 (8 x 32 and a 16 x 16 global window) and 384 tokens
KA_MMA_GEOMS = [(128, 128, 1, 128), (128, 128, 128, 1), (28, 28, 7, 28), (32, 32, 8, 32),
                (16, 16, 16, 16), (32, 24, 16, 24)]


def _bf16_qkv(dev, B, L, C, wide=None):
    """q, k, v as column slices of one qkv tensor, and the LePE kernel, bf16."""
    qkv = _randn(dev, B, L, 3 * C, scale=0.5).to(torch.bfloat16)
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(torch.bfloat16)
    return qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], lk


def _check_fwd(got, want, dtype=torch.bfloat16):
    """A forward output at both scales: max(1, max|plain|) and its own."""
    _check(got, want, dtype)
    _check_own(got, want, dtype)


def _fwd_bodies():
    return {n: c for n, c in _build.BODY_LAUNCHES.items() if c}


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("H,W,hsp,wsp", KA_MMA_GEOMS)
def test_stripe_attention_tensor_core_body(dev, rate, D, H, W, hsp, wsp):
    """K-A's bf16 tensor-core body against the plain version, mask for mask,
    batch 2, two heads of head dim D, with the LePE and without it (zero
    taps), where the output is the attention alone and its own scale sees an
    error in p that the LePE's larger values would hide: every launch takes
    the tensor-core body."""
    q, k, v, lk = _bf16_qkv(dev, 2, H * W, 2 * D)
    kw = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=2, attn_drop=rate, seed=17)
    _build.reset_launches()
    for taps in (lk, torch.zeros_like(lk)):
        got = stripe_attention.attention_fwd(q, k, v, taps, **kw)
        assert got.shape == q.shape and got.dtype == torch.bfloat16
        _check_fwd(got, attention.stripe_attention(*(t.float() for t in (q, k, v, taps)), **kw))
    assert _fwd_bodies() == {f"{stripe_attention.KERNEL}:mma": 2}


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("H,W,hsp,wsp,C,heads", MMA_GEOMS)
def test_flash_fwd_tensor_core_body(dev, rate, H, W, hsp, wsp, C, heads):
    """The flash forward's bf16 tensor-core body against the plain versions,
    mask for mask, batch 2: window mode (the tiled K-A, with the LePE and
    without it: out against the v2 version, L against the windows'
    log-sum-exp) and, where the windows span
    the width, flash mode (out and L against the plain flash forward).  L is
    held in float32, at 1e-4, against the plain version on the same bf16
    inputs; every launch takes the tensor-core body."""
    q, k, v, lk = _bf16_qkv(dev, 2, H * W, C)
    kw = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=rate, seed=19)
    geo = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=heads)
    _build.reset_launches()
    for taps in (lk, torch.zeros_like(lk)):  # with the LePE, and the attention alone
        out, lse = stripe_attention.tiled_fwd(q, k, v, taps, **kw)
        _check_fwd(out, attention.stripe_attention(*(t.float() for t in (q, k, v, taps)), **kw))
        _check_scaled(lse, attention.stripe_attention_lse(q, k, **geo), torch.float32)
    modes = ["window"]
    if wsp == W:
        modes.append("flash")
        N = hsp * wsp
        ref_kw = dict(heads=heads, attn_drop=rate, seed=19)
        bands = [t.reshape(-1, N, C) for t in (q, k, v)]
        out_ref, _ = flash_attention.flash_attention_reference(*(t.float() for t in bands),
                                                               **ref_kw)
        _, lse_ref = flash_attention.flash_attention_reference(*bands, **ref_kw)
        out, lse = flash_attention.kernel_fwd(q, k, v, None, **kw, mode="flash")
        _check_fwd(out.reshape(out_ref.shape), out_ref)
        _check_scaled(lse, lse_ref, torch.float32)
    assert _fwd_bodies() == {f"{flash_attention.FWD_KERNEL}:{m}:mma": 1 + (m == "window")
                             for m in modes}


@pytest.mark.parametrize("dtype,D,body", [
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 8, "fma"), (torch.float32, 32, "fma"), (torch.float32, 64, "fma")])
def test_attention_fwd_body_by_dtype_and_head_dim(dev, dtype, D, body):
    """The two forward entries pick their body as dq and dk/dv do: bf16 at
    head dims 16, 32 and 64 the tensor-core body, float32 and head dim 8 the
    CUDA-core body; K-A, the tiled K-A and the flash forward each right."""
    H, C = 20, 2 * D
    qkv = _randn(dev, 2, H * H, 3 * C, scale=0.5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(dtype)
    kw = dict(H=H, W=H, hsp=H, wsp=H, num_heads=2, attn_drop=0.3, seed=23)
    f32 = [t.float() for t in (q, k, v, lk)]
    assert flash_attention.kernel_body(q, D) == body
    _build.reset_launches()
    want = attention.stripe_attention(*f32, **kw)
    _check_fwd(stripe_attention.attention_fwd(q, k, v, lk, **kw), want, dtype)
    _check_fwd(stripe_attention.tiled_fwd(q, k, v, lk, **kw)[0], want, dtype)
    out, _ = flash_attention.kernel_fwd(q, k, v, None, **kw, mode="flash")
    want, _ = flash_attention.flash_attention_reference(
        *(t.reshape(-1, H * H, C) for t in f32[:3]), heads=2, attn_drop=0.3, seed=23)
    _check_fwd(out.reshape(want.shape), want, dtype)
    assert _fwd_bodies() == {f"{stripe_attention.KERNEL}:{body}": 1,
                             **{f"{flash_attention.FWD_KERNEL}:{m}:{body}": 1
                                for m in ("window", "flash")}}


def test_attention_fwd_tensor_core_copies_unaligned_rows(dev):
    """q, k and v whose base and row stride are not 16-byte aligned (column
    slices of a 3C + 1 wide tensor) reach the tensor-core forwards as
    explicit aligned copies: K-A, the tiled K-A and the flash forward give
    exactly what contiguous inputs give."""
    C, H = 32, 20
    wide = _randn(dev, 2, H * H, 3 * C + 1, scale=0.5).to(torch.bfloat16)
    q, k, v = wide[..., 1:C + 1], wide[..., C + 1:2 * C + 1], wide[..., 2 * C + 1:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(torch.bfloat16)
    kw = dict(H=H, W=H, hsp=H, wsp=H, num_heads=1, attn_drop=0.3, seed=5)
    _build.reset_launches()
    calls = (lambda *t: (stripe_attention.attention_fwd(*t, lk, **kw),),
             lambda *t: stripe_attention.tiled_fwd(*t, lk, **kw),
             lambda *t: flash_attention.kernel_fwd(*t, None, **kw, mode="flash"))
    for call in calls:
        for a, b in zip(call(q, k, v), call(*(t.contiguous() for t in (q, k, v)))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _fwd_bodies() == {f"{stripe_attention.KERNEL}:mma": 2,
                             **{f"{flash_attention.FWD_KERNEL}:{m}:mma": 2
                                for m in ("window", "flash")}}


def test_attention_fwd_tensor_core_very_negative_scores(dev):
    """Windows whose scores are all about -100 (q and k opposite along a
    shared component), 196 tokens for K-A and 420 for the flash forward
    (both modes; neither a multiple of the 64-key tiles): finite outputs
    that agree with the plain versions, and L about -100."""
    C = 32
    for H, W in ((7, 28), (20, 21)):
        q = (4.2 + 0.1 * _randn(dev, 1, H * W, C)).to(torch.bfloat16)
        k = (-4.2 + 0.1 * _randn(dev, 1, H * W, C, seed=1)).to(torch.bfloat16)
        v = _randn(dev, 1, H * W, C, scale=0.5, seed=2).to(torch.bfloat16)
        lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=3).to(torch.bfloat16)
        kw = dict(H=H, W=W, hsp=H, wsp=W, num_heads=1)
        f32 = [t.float() for t in (q, k, v, lk)]
        want = attention.stripe_attention(*f32, **kw)
        if H * W <= 256:
            pairs = [(stripe_attention.attention_fwd(q, k, v, lk, **kw), want)]
        else:
            out, lse = stripe_attention.tiled_fwd(q, k, v, lk, **kw)
            assert float(lse.max()) < -88.0 and bool(torch.isfinite(lse).all())
            flash, lse = flash_attention.kernel_fwd(q, k, v, None, **kw, mode="flash")
            assert float(lse.max()) < -88.0 and bool(torch.isfinite(lse).all())
            want_flash, _ = flash_attention.flash_attention_reference(
                *(t.reshape(1, H * W, C) for t in f32[:3]), heads=1)
            pairs = [(out, want), (flash.reshape(want_flash.shape), want_flash)]
        for got, ref in pairs:
            assert bool(torch.isfinite(got).all())
            _check(got, ref, torch.bfloat16)


def test_model_512_forward_runs_tensor_core_stripe_attention(dev):
    """A bf16 forward of CSWin-SimAM-UNet at 512^2 launches K-A's
    tensor-core body for each of its 50 attention branches and no CUDA-core
    body; the float32 model the CUDA-core body only."""
    x = torch.rand(1, 512, 512, 3, device=dev)
    for dtype, body in (("bfloat16", "mma"), ("float32", "fma")):
        model = build_model("cswin_simam_512", device=dev, seed=0, dtype=dtype)
        _build.reset_launches()
        with torch.inference_mode():
            p = model.predict(x)
        assert _fwd_bodies() == {f"{stripe_attention.KERNEL}:{body}": 50}
        assert bool(torch.isfinite(p).all())


# ---- the bf16 tensor-core K-A': the tiled K-A' dq and dk/dv bodies
# (csrc/flash_attention_mma.cuh) launched from the K-A' entry at the
# whole-window mask, from the L that K-A's tensor-core body saves ----

@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("H,W,hsp,wsp", KA_MMA_GEOMS)
def test_stripe_attention_bwd_tensor_core_body(dev, rate, D, H, W, hsp, wsp):
    """The bf16 tensor-core K-A' against the plain version, mask for
    mask, batch 2, two heads of head dim D, with the LePE and without it
    (zero taps: dv is P^T dO alone, which the LePE's transpose would hide):
    dq, dk, dv and dw each at max(1, max|plain|) and at its own max|plain|;
    every launch of K-A and K-A' takes the tensor-core body."""
    q, k, v, lk = _bf16_qkv(dev, 2, H * W, 2 * D)
    g = _randn(dev, 2, H * W, 2 * D, seed=2).to(torch.bfloat16)
    kw = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=2, attn_drop=rate, seed=31)
    _build.reset_launches()
    for taps in (lk, torch.zeros_like(lk)):
        got = _ka_bwd(q, k, v, taps, g, **kw)
        want = attention.stripe_attention_bwd_reference(
            *(t.float() for t in (q, k, v, taps, g)), **kw)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == torch.bfloat16
            _check(a, b, torch.bfloat16)
            _check_own(a, b, torch.bfloat16)
    assert _fwd_bodies() == {f"{stripe_attention.KERNEL}:mma": 2,
                             f"{stripe_attention.BWD_KERNEL}:mma": 2}


@pytest.mark.parametrize("dtype,D,body", [
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 8, "fma"), (torch.float32, 32, "fma"), (torch.float32, 64, "fma")])
def test_stripe_attention_bwd_body_by_dtype_and_head_dim(dev, dtype, D, body):
    """K-A' picks its body as K-A does: bf16 at head dims 16, 32 and 64 the
    tensor-core body, float32 and head dim 8 the CUDA-core body (whose K-A
    saves no L), each right at a 144-token window with dropout."""
    H, C = 12, 2 * D
    qkv = _randn(dev, 2, H * H, 3 * C, scale=0.5).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(dtype)
    g = _randn(dev, 2, H * H, C, seed=2).to(dtype)
    kw = dict(H=H, W=H, hsp=H, wsp=H, num_heads=2, attn_drop=0.3, seed=37)
    assert flash_attention.kernel_body(q, D) == body
    _build.reset_launches()
    _, lse = stripe_attention.attention_fwd(q, k, v, lk, **kw, with_lse=True)
    assert (lse is None) == (body == "fma")
    got = stripe_attention.attention_bwd(q, k, v, lk, g, **kw, lse=lse)
    want = attention.stripe_attention_bwd_reference(*(t.float() for t in (q, k, v, lk, g)),
                                                    **kw)
    for a, b in zip(got, want):
        _check(a, b, dtype)
        if dtype == torch.bfloat16:
            _check_own(a, b, dtype)
    assert _fwd_bodies() == {f"{stripe_attention.KERNEL}:{body}": 1,
                             f"{stripe_attention.BWD_KERNEL}:{body}": 1}


def test_stripe_attention_bwd_tensor_core_needs_lse(dev):
    """The tensor-core K-A' reads the forward's L: without it, or with one
    of another shape, the wrapper raises before any launch."""
    q, k, v, lk = _bf16_qkv(dev, 1, 256, 32)
    kw = dict(H=16, W=16, hsp=16, wsp=16, num_heads=1)
    _build.reset_launches()
    for lse in (None, torch.zeros(1, 256, 2, device=dev)):
        with pytest.raises(ValueError, match="lse"):
            stripe_attention.attention_bwd(q, k, v, lk, q, **kw, lse=lse)
    assert _build.LAUNCHES[stripe_attention.BWD_KERNEL] == 0


def test_stripe_attention_bwd_tensor_core_copies_unaligned_rows(dev):
    """q, k, v and dO whose base or row stride is not 16-byte aligned (column
    slices of a 3C + 1 wide tensor) reach the tensor-core K-A' as
    explicit aligned copies: dq, dk, dv and dw equal those of contiguous
    inputs."""
    C, H = 32, 16
    wide = _randn(dev, 2, H * H, 3 * C + 1, scale=0.5).to(torch.bfloat16)
    q, k, v = wide[..., 1:C + 1], wide[..., C + 1:2 * C + 1], wide[..., 2 * C + 1:]
    g = _randn(dev, 2, H * H, C + 1, seed=2).to(torch.bfloat16)[..., 1:]
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=1).to(torch.bfloat16)
    kw = dict(H=H, W=H, hsp=2, wsp=H, num_heads=1, attn_drop=0.3, seed=5)
    _build.reset_launches()
    got = _ka_bwd(q, k, v, lk, g, **kw)
    want = _ka_bwd(*(t.contiguous() for t in (q, k, v)), lk, g.contiguous(), **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _fwd_bodies() == {f"{stripe_attention.KERNEL}:mma": 2,
                             f"{stripe_attention.BWD_KERNEL}:mma": 2}


def test_stripe_attention_bwd_tensor_core_very_negative_scores(dev):
    """A 196-token window (7 x 28: not a multiple of the 64-row tiles or of
    the 16-key chunks) whose scores are all about -100, so L < -88: the
    zero-filled rows past N must give p = 0, not exp(-L) = inf; dq, dk, dv
    and dw finite and within the max(1, .) scale (q and k share a large
    component, along which the bf16 rounding of ds, which the float32 plain
    version skips, sums without cancelling)."""
    C, H, W = 32, 7, 28
    q = (4.2 + 0.1 * _randn(dev, 1, H * W, C)).to(torch.bfloat16)
    k = (-4.2 + 0.1 * _randn(dev, 1, H * W, C, seed=1)).to(torch.bfloat16)
    v = _randn(dev, 1, H * W, C, scale=0.5, seed=2).to(torch.bfloat16)
    lk = _randn(dev, 3, 3, 1, C, scale=0.3, seed=3).to(torch.bfloat16)
    g = _randn(dev, 1, H * W, C, seed=4).to(torch.bfloat16)
    kw = dict(H=H, W=W, hsp=H, wsp=W, num_heads=1)
    _, lse = stripe_attention.attention_fwd(q, k, v, lk, **kw, with_lse=True)
    assert float(lse.max()) < -88.0 and bool(torch.isfinite(lse).all())
    got = stripe_attention.attention_bwd(q, k, v, lk, g, **kw, lse=lse)
    want = attention.stripe_attention_bwd_reference(
        *(t.float() for t in (q, k, v, lk, g)), **kw)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        _check_scaled(a, b, torch.bfloat16)


@pytest.mark.parametrize("H,W,hsp,wsp", KA_MMA_GEOMS)
def test_stripe_attention_tensor_core_saves_lse(dev, H, W, hsp, wsp):
    """The L that K-A's tensor-core body saves for K-A', (B * windows, N,
    heads) float32, against ``stripe_attention_lse`` on the same bf16
    inputs at 1e-4 x max(1, max|L|), with dropout (L sums the undropped
    p); the float32 call, on the CUDA-core body, saves none."""
    q, k, v, lk = _bf16_qkv(dev, 2, H * W, 64)
    kw = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=2)
    _, lse = stripe_attention.attention_fwd(q, k, v, lk, **kw, attn_drop=0.3, seed=3,
                                            with_lse=True)
    assert lse.shape == (2 * (H // hsp) * (W // wsp), hsp * wsp, 2)
    _check_scaled(lse, attention.stripe_attention_lse(q, k, **kw), torch.float32)
    f32 = [t.float() for t in (q, k, v, lk)]
    assert stripe_attention.attention_fwd(*f32, **kw, with_lse=True)[1] is None


def test_model_512_training_step_runs_tensor_core_stripe_attention_bwd(dev):
    """A bf16 training step of CSWin-SimAM-UNet at 512^2 launches K-A's and
    K-A' tensor-core bodies for each of its 50 attention branches and no
    CUDA-core body; a cswinunet step (float32, 448^2) the CUDA-core bodies
    only; both losses finite."""
    for name, img, body in (("cswin_simam_512", 512, "mma"), ("cswinunet", 448, "fma")):
        model = build_model(name, device=dev, seed=0)
        n = len([m for m in model.modules() if isinstance(m, LePEAttention)])
        x = torch.rand(1, img, img, 3, device=dev)
        opt = engine.make_optimizer("adamw", 1e-4, 1e-4, model.parameters())
        step = engine.make_train_step(model, opt, seed=0)
        images = (x * 255).to(torch.uint8)
        masks = ((x[..., :1] > 0.5) * 255).to(torch.uint8)
        _build.reset_launches()
        out = step(images, masks)
        assert _fwd_bodies() == {f"{stripe_attention.KERNEL}:{body}": n,
                                 f"{stripe_attention.BWD_KERNEL}:{body}": n}, name
        assert n == 50 or name == "cswinunet"
        assert all(bool(torch.isfinite(torch.as_tensor(val))) for val in out.values())


# ---- the last six kernel bodies: K-LN, K-LN', K5 (with and without the
# gate), K-V1, K-V1' ----

# every LayerNorm shape (rows M = B*L, channels C) of cswin_simam_512 at
# batch 8, cswinunet at batch 2 and cswin_simam_2048 at batch 1
LN_CONFIG_SHAPES = [(8 * 128 * 128 >> 2 * s, 64 << s) for s in range(4)] + [
    (2 * 112 * 112 >> 2 * s, 64 << s) for s in range(4)] + [
    (512 * 512 >> 2 * s, 64 << s) for s in range(4)]
# odd shapes: one row, ragged last blocks, C off the vector width (the
# scalar body: 33, 100; 96 in bf16), C = 8 (a lane a row), C = 512
LN_ODD_SHAPES = [(200, 64), (131, 96), (64, 512), (37, 33), (70, 8), (1, 8), (1, 512),
                 (131, 100), (1000, 100), (263 * 500 + 1, 64), (2049, 512), (8191, 256)]


def _ln_inputs(dev, dtype, M, C):
    x = (_randn(dev, M, C, scale=2.0) + 0.5).to(dtype)
    dy = _randn(dev, M, C, seed=1).to(dtype)
    g = _randn(dev, C, scale=0.3, seed=2) + 1.0
    return x, dy, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C", LN_ODD_SHAPES + LN_CONFIG_SHAPES)
def test_layernorm_kernels(dev, dtype, M, C):
    """K-LN and K-LN' against their plain versions; dx, dg and db each also
    against its own max|plain|, and the body K-LN' took (16-byte loads
    where C is a multiple of 16 bytes' elements)."""
    x, dy, g = _ln_inputs(dev, dtype, M, C)
    b = _randn(dev, C, scale=0.1, seed=3)
    _build.reset_launches()
    y = layernorm.kernel_fwd(x, g, b)
    got = layernorm.kernel_bwd(x, g, dy)
    assert _build.LAUNCHES[layernorm.FWD_KERNEL] == _build.LAUNCHES[layernorm.BWD_KERNEL] == 1
    body = "vec" if C % (16 // x.element_size()) == 0 else "scalar"
    assert {n: c for n, c in _build.BODY_LAUNCHES.items() if c} == {
        f"{layernorm.BWD_KERNEL}:{body}": 1}
    assert y.dtype == got[0].dtype == dtype and got[1].dtype == torch.float32
    _check(y, layernorm.ln_reference(x.float(), g, b), dtype)
    for a, r in zip(got, layernorm.ln_bwd_reference(x.float(), g, dy.float())):
        _check_scaled(a, r, dtype)
        _check_own(a, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_bwd_unaligned_rows_take_the_scalar_body(dev, dtype):
    """Rows whose base is not 16-byte aligned: the scalar body, the same
    answers."""
    M, C = 300, 64
    x, dy, g = _ln_inputs(dev, dtype, M * C + 1, 1)
    x, dy = x.reshape(-1)[1:].view(M, C), dy.reshape(-1)[1:].view(M, C)
    g = _randn(dev, C, scale=0.3, seed=2) + 1.0
    assert x.data_ptr() % 16 and x.is_contiguous()
    _build.reset_launches()
    got = layernorm.kernel_bwd(x, g, dy)
    assert {n: c for n, c in _build.BODY_LAUNCHES.items() if c} == {
        f"{layernorm.BWD_KERNEL}:scalar": 1}
    for a, r in zip(got, layernorm.ln_bwd_reference(x.float(), g, dy.float())):
        _check_scaled(a, r, dtype)
        _check_own(a, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C", [(131072, 64), (2048, 512), (392, 512), (1000, 100),
                                 (263 * 500 + 1, 64)])
def test_layernorm_bwd_deterministic(dev, dtype, M, C):
    """Two runs of K-LN' on the same inputs give the same bits: dg and db
    are summed in a fixed order, without atomics."""
    x, dy, g = _ln_inputs(dev, dtype, M, C)
    first = layernorm.kernel_bwd(x, g, dy)
    second = layernorm.kernel_bwd(x, g, dy)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_layernorm_bwd_design_matches_the_c_entry(dev):
    """The wrapper's mirror of K-LN''s launch shape (ops/layernorm.py::
    bwd_geometry) and the C entry's, over dtypes, row counts, every C from 1
    to 512, aligned rows or not, and the SM counts of other cards."""
    lib = _build.library()
    out = (ctypes.c_int64 * 7)()
    keys = ("vec", "lanes", "vpl", "in_flight", "warps", "rows", "blocks")
    sms_here = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for sms in sorted({sms_here, 132, 108, 1}):
            for M in (1, 7, 37, 263, 264, 265, 392, 1000, 2048, 8191, 25088, 131072, 262144):
                for C in range(1, layernorm.MAX_CHANNELS + 1):
                    for aligned in (True, False):
                        code = lib.csu_layernorm_bwd_design(_build.DTYPE_CODES[dtype], M, C,
                                                            int(aligned), sms, out)
                        assert code == 0
                        geo = layernorm.bwd_geometry(M, C, dtype, aligned, sms)
                        assert {k: geo[k] for k in keys} == dict(zip(keys, out)), (M, C)
    for M, C in ((0, 64), (4, 0), (4, 513)):
        assert lib.csu_layernorm_bwd_design(1, M, C, 1, 132, out) != 0


def test_layernorm_kernel_rejects(dev):
    with pytest.raises(ValueError, match="channels"):
        layernorm.kernel_fwd(torch.zeros(4, 520, device=dev), torch.ones(520, device=dev),
                             torch.zeros(520, device=dev))
    x = torch.zeros(100, 64, device=dev)
    with pytest.raises(RuntimeError, match="csu_layernorm_bwd failed"):  # partials' size
        _build.launch(layernorm.BWD_KERNEL, dev, 0, x.data_ptr(), x.data_ptr(), x.data_ptr(),
                      x.data_ptr(), x.data_ptr(), x.data_ptr(), 100, 64, 1e-5, 132, 7)


def _head_bwd2_inputs(dev, dtype, H, W, C, G, F, B=2, pooled_only=False):
    """fb, dy, mu, v, A, Bq, w of K5: A and B from the plain K3, or with
    ``pooled_only`` dy = 0 and A, B of order 100, so that dx is the two
    pooled terms alone (about 1/N of dx at the flagship otherwise)."""
    fb = _randn(dev, B, H, W, G * C, seed=2).to(dtype)
    dy = _randn(dev, B, H, W, G * F, seed=3).to(dtype)
    w = _randn(dev, C, F, scale=C ** -0.5, seed=4)
    f = fb.float()
    mu, v = pooled_stats(f.sum((1, 2)), (f * f).sum((1, 2)), H * W * G, G)
    if pooled_only:
        return (fb, torch.zeros_like(dy), mu, v, _randn(dev, B, C, scale=100.0, seed=5),
                _randn(dev, B, C, scale=100.0, seed=6), w)
    A, Bq, _ = carafe_head.head_bwd1_reference(f, dy.float(), mu, v, w, G)
    return fb, dy, mu, v, A, Bq, w


# K5's checks: a map that fills neither a chunk nor U pixels (7 x 9), F 1, 2,
# 3, 5 and 8 (every class bound), scalar slots (C 6), G 4 and 16
HEAD_BWD2_GEOMS = [(8, 8, 16, 16, 1), (4, 6, 8, 4, 3), (4, 4, 6, 4, 8), (6, 20, 64, 16, 4),
                   (7, 9, 16, 16, 2), (7, 9, 24, 4, 5), (7, 9, 64, 16, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("H,W,C,G,F", HEAD_BWD2_GEOMS)
def test_head_bwd2_kernels(dev, dtype, gate, H, W, C, G, F):
    """K5 and K5 without the gate against the plain version: dx and db each
    at max(1, max|plain|) and at its own max|plain|, and two runs bit for
    bit (fixed-order partials, no atomics)."""
    fb, dy, mu, v, A, Bq, w = _head_bwd2_inputs(dev, dtype, H, W, C, G, F)
    _build.reset_launches()
    got = simam_head.head_bwd2(fb, dy, mu, v, A, Bq, w, G, gate=gate)
    name = simam_head.BWD2_KERNEL if gate else simam_head.BWD2_NOGATE_KERNEL
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {name: 1}
    want = carafe_head.head_bwd2_reference(fb.float(), dy.float(), mu, v, A, Bq, w, G,
                                           gate=gate)
    assert got[0].dtype == dtype and got[0].shape == fb.shape and got[1].shape == (C,)
    for a, r in zip(got, want):
        _check_scaled(a, r, dtype)
        _check_own(a, r, dtype)
    again = simam_head.head_bwd2(fb, dy, mu, v, A, Bq, w, G, gate=gate)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,G,F", [(7, 9, 16, 16, 1), (4, 6, 8, 4, 3)])
def test_head_bwd2_pooled_terms(dev, dtype, H, W, C, G, F):
    """K5 with dy = 0 and A, B of order 100: dx = -(2 w4 / N) A - (8 w4^2 /
    (N-1)) B (x - mu) alone, dx and db each at its own max|plain|."""
    fb, dy, mu, v, A, Bq, w = _head_bwd2_inputs(dev, dtype, H, W, C, G, F, pooled_only=True)
    got = simam_head.head_bwd2(fb, dy, mu, v, A, Bq, w, G)
    want = carafe_head.head_bwd2_reference(fb.float(), dy.float(), mu, v, A, Bq, w, G)
    assert float(want[0].abs().max()) > 0.1
    for a, r in zip(got, want):
        _check_scaled(a, r, dtype)
        _check_own(a, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [True, False])
def test_head_bwd_kernels_wide(dev, dtype, gate):
    """K3 and K5 at G 16, C 1024: 2048 (bf16) or 4096 (float32) channel
    vectors a pixel, more than a block's threads, in slices over blockIdx.y
    (JAX's simam_head takes any G*C); each output against the plain version
    at both scales."""
    H, W, C, G, F = 5, 7, 1024, 16, 3
    fb, dy, mu, v, A, Bq, w = _head_bwd2_inputs(dev, dtype, H, W, C, G, F, B=1)
    f = fb.float()
    _build.reset_launches()
    got = carafe_head.head_bwd1(fb, dy, mu if gate else None, v if gate else None, w, G,
                                gate=gate)
    want = carafe_head.head_bwd1_reference(f, dy.float(), mu, v, w, G, gate=gate)
    for a, r in zip(got, want):
        if r is not None:
            _check_scaled(a, r, dtype)
            _check_own(a, r, dtype)
    got = simam_head.head_bwd2(fb, dy, mu, v, A, Bq, w, G, gate=gate)
    want = carafe_head.head_bwd2_reference(f, dy.float(), mu, v, A, Bq, w, G, gate=gate)
    for a, r in zip(got, want):
        _check_scaled(a, r, dtype)
        _check_own(a, r, dtype)
    names = ((carafe_head.BWD1_KERNEL, simam_head.BWD2_KERNEL) if gate else
             (carafe_head.BWD1_NOGATE_KERNEL, simam_head.BWD2_NOGATE_KERNEL))
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {n: 1 for n in names}


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


def _v1_cases():
    """(dtype, G, Np, n_valid, D) of the v1 kernel checks: the first cases in
    float32 and bf16; then bf16 at head dims 16, 32 and 64 (the tensor-core
    bodies) at the flagship's windows, cswinunet's padded ones, a window
    past the whole-window body's limit, the longest window and a single
    attended key, G 1, 3 and 5; then float32 and head dim 8 (the CUDA-core
    bodies) at the flagship's window."""
    cases = [(dtype, *c) for dtype in (torch.float32, torch.bfloat16)
             for c in [(6, 16, 16, 8), (4, 112, 98, 16), (3, 208, 196, 32), (2, 256, 256, 64),
                       (1, 2048, 2041, 32)]]
    windows = [(128, 128), (256, 256), (112, 98), (208, 196), (512, 500), (2048, 2041),
               (64, 1)]
    cases += [(torch.bfloat16, (1, 3, 5)[i % 3], Np, n_valid, D)
              for i, ((Np, n_valid), D) in enumerate(
                  (w, D) for D in (16, 32, 64) for w in windows)]
    cases += [(torch.float32, 3, 256, 256, 32), (torch.float32, 5, 112, 98, 64),
              (torch.bfloat16, 3, 128, 128, 8)]
    return cases


def _v1_body(dtype, D):
    return "mma" if dtype == torch.bfloat16 and D in (16, 32, 64) else "fma"


@pytest.mark.parametrize("dtype,G,Np,n_valid,D", _v1_cases())
def test_window_attention_kernels(dev, dtype, G, Np, n_valid, D):
    """K-V1 and K-V1' against the plain versions: out, dq, dk and dv each
    also against its own max|plain| (they sit far below 1), masked keys
    with dk = dv = 0 exactly, padded query rows (nonzero dO there) with
    their dq, and the body each launch took."""
    q, k, v, do = (_randn(dev, G, Np, D, scale=0.5, seed=s).to(dtype) for s in range(4))
    scale = D ** -0.5
    _build.reset_launches()
    out, lse = window_attention.kernel_fwd(q, k, v, scale, n_valid)
    got = window_attention.kernel_bwd(q, k, v, lse, do, scale, n_valid)
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        window_attention.FWD_KERNEL: 1, window_attention.BWD_KERNEL: 1}
    body = _v1_body(dtype, D)
    assert {n: c for n, c in _build.BODY_LAUNCHES.items() if c} == {
        f"{window_attention.FWD_KERNEL}:{body}": 1, f"{window_attention.BWD_KERNEL}:{body}": 1}
    qf, kf, vf = q.float(), k.float(), v.float()
    want_out = window_attention.window_attention_reference(qf, kf, vf, scale, n_valid)
    _check(out, want_out, dtype)
    _check_own(out, want_out, dtype)
    want = window_attention.window_attention_bwd_reference(qf, kf, vf, do.float(), scale,
                                                           n_valid)
    def own_or_zero(a, r):
        if float(r.abs().max()) > 0.0:
            _check_own(a, r, dtype)
        else:  # n_valid 1: p is one-hot, so ds, dq and dk are 0
            assert float(a.float().abs().max()) <= 1e-4

    for a, r in zip(got, want):
        _check_scaled(a, r, dtype)
        own_or_zero(a, r)
    assert float(got[1][:, n_valid:].abs().sum()) == 0.0  # masked keys: dk = dv = 0
    assert float(got[2][:, n_valid:].abs().sum()) == 0.0
    if n_valid < Np:  # the padded query rows, whose dO is not zero
        own_or_zero(got[0][:, n_valid:], want[0][:, n_valid:])


def test_window_attention_design_matches_the_c_entry(dev):
    """The wrapper's mirror of K-V1''s body choice and the C entry's."""
    lib = _build.library()
    for dtype in (torch.float32, torch.bfloat16):
        for D in (8, 16, 32, 64):
            for Np in (1, 16, 100, 112, 128, 208, 224, 240, 256, 272, 512, 2048):
                code = lib.csu_window_attention_design(_build.DTYPE_CODES[dtype], D, Np)
                assert ("fma", "tiled", "whole")[code] == window_attention.design(dtype, D, Np)


@pytest.mark.parametrize("dtype,Np,n_valid,D", [
    (torch.bfloat16, 256, 256, 32),   # the whole-window body
    (torch.bfloat16, 208, 196, 64),
    (torch.bfloat16, 512, 500, 32),   # the tiled bodies
    (torch.float32, 112, 98, 16)])    # the CUDA-core bodies
def test_window_attention_kernels_deterministic(dev, dtype, Np, n_valid, D):
    """Two runs of K-V1 and K-V1' on the same inputs are bit-equal."""
    q, k, v, do = (_randn(dev, 5, Np, D, scale=0.5, seed=s).to(dtype) for s in range(4))
    runs = []
    for _ in range(2):
        out, lse = window_attention.kernel_fwd(q, k, v, 0.3, n_valid)
        runs.append((out, lse, *window_attention.kernel_bwd(q, k, v, lse, do, 0.3, n_valid)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,Np,n_valid,D", [
    (torch.bfloat16, 112, 98, 32), (torch.bfloat16, 512, 500, 16),
    (torch.float32, 128, 128, 32)])
def test_window_attention_one_hot_key(dev, dtype, Np, n_valid, D):
    """Key j scores 30 above every other: each output row is v_j, dv lands
    on key j alone (the sum of dO), and dq, dk are as the plain version's
    (near 0)."""
    j, G = 37, 3
    q, k = (_randn(dev, G, Np, D, scale=0.05, seed=s) for s in (0, 1))
    v, do = (_randn(dev, G, Np, D, scale=0.5, seed=s) for s in (2, 3))
    scale = D ** -0.5
    q[..., 0] = 1.0
    k[..., 0] = 0.0
    k[:, j, 0] = 30.0 / scale
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    out, lse = window_attention.kernel_fwd(q, k, v, scale, n_valid)
    dq, dk, dv = window_attention.kernel_bwd(q, k, v, lse, do, scale, n_valid)
    _check(out, v[:, j:j + 1].float().expand(G, Np, D), dtype)
    _check(dv[:, j], do.float().sum(1), dtype)
    others = torch.arange(Np, device=dev) != j
    assert float(dv[:, others].float().abs().max()) < 1e-6
    want = window_attention.window_attention_bwd_reference(
        q.float(), k.float(), v.float(), do.float(), scale, n_valid)
    for a, r in zip((dq, dk, dv), want):
        _check_scaled(a, r, dtype)


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


# ---- the UNet family: no kernel of the port; the card against the CPU ----

def _unet_pair(dev, use_simam, n_classes=1, dtype=torch.float32, seed=20):
    """The same UNet (width 8) on the CPU and on the card, computing in
    ``dtype``; its parameters and statistics float64 for float64, else
    float32."""
    cpu = UNet(n_classes=n_classes, base_features=8, use_simam=use_simam, device="cpu",
               seed=seed, dtype=dtype)
    if dtype == torch.float64:
        cpu.double()
    return cpu, copy.deepcopy(cpu).to(dev)


def _unet_step(model, images, masks, n_classes, grad_accum=1):
    opt = engine.make_optimizer("adam", 1e-3, 1e-4, model.parameters())
    m = engine.make_train_step(model, opt, n_classes, grad_accum=grad_accum)(images, masks)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


@pytest.mark.parametrize("use_simam,n_classes,accum", [(False, 1, 1), (True, 1, 2),
                                                       (True, 4, 1)])
def test_unet_step_on_card_matches_cpu(dev, monkeypatch, use_simam, n_classes, accum):
    """One Adam step (``grad_accum`` 2 over a ragged batch of 3 among them)
    on the card and on the CPU from the same weights and batch.  float32:
    no kernel launched, the loss within 1e-5, Dice and IoU within 2e-3 (a
    few thresholded pixels), the running statistics within 2e-4 x max(1,
    |CPU|).  bf16 (``--bf16``; the statistics float32): the loss within
    1e-3, Dice and IoU within 2e-2, the running statistics within 1e-2 x
    max(1, |CPU|), float32 and finite gradients (bf16 against float32, in
    the port and in JAX alike, moves the BatchNorm layers' gradients of a
    random-init UNet by up to ~60 % in relative norm: no value check).
    float64 (``Tensor.float`` widened, nothing rounds to float32): the
    metrics, every gradient (x max|g|; the conv biases before a BatchNorm,
    whose gradient is rounding noise, against their weight's), the running
    statistics and the parameters within 1e-9."""
    images, masks = _uint8_batch(3 if accum > 1 else 2, 21, n_classes)
    for dtype, tol_loss, tol_counted, tol_stats in ((torch.float32, 1e-5, 2e-3, 2e-4),
                                                    (torch.bfloat16, 1e-3, 2e-2, 1e-2)):
        cpu, card = _unet_pair(dev, use_simam, n_classes, dtype)
        _build.reset_launches()
        got, g_card = _unet_step(card, images, masks, n_classes, accum)
        assert not _launched()
        want, _ = _unet_step(cpu, images, masks, n_classes, accum)
        assert abs(got["loss"] - want["loss"]) <= tol_loss * max(1.0, abs(want["loss"])), dtype
        assert all(abs(got[k] - want[k]) <= tol_counted for k in ("dice", "iou")), (got, want)
        for (name, a), b in zip(card.named_buffers(), cpu.buffers()):
            assert a.dtype == b.dtype and b.dtype in (torch.float32, torch.long), (name, b.dtype)
            err = float((a.cpu().double() - b.double()).abs().max())
            assert err <= tol_stats * max(1.0, float(b.double().abs().max())), (name, dtype, err)
        for name, g in g_card.items():
            assert g.dtype == torch.float32 and bool(g.isfinite().all()), (name, dtype)

    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    cpu, card = _unet_pair(dev, use_simam, n_classes, torch.float64)
    got, g_card = _unet_step(card, images, masks, n_classes, accum)
    want, g_cpu = _unet_step(cpu, images, masks, n_classes, accum)
    assert all(abs(got[k] - want[k]) <= 1e-9 for k in got), (got, want)
    for name, g in g_cpu.items():
        scale = g_cpu[name[:-4] + "weight"] if name.endswith(("0.bias", "3.bias")) else g
        err = float((g_card[name] - g).abs().max())
        assert err <= 1e-9 * max(float(scale.abs().max()), 1e-30), (name, err)
    for (name, a), b in zip(card.state_dict().items(), cpu.state_dict().values()):
        assert float((a.cpu().double() - b.double()).abs().max()) <= 1e-9, name


def test_unet_eval_and_serving_on_card_match_cpu(dev):
    """After a training step on the CPU (running statistics moved), the
    same weights and buffers on the card: the eval step's metrics, and
    ``Server``'s probabilities for a request of 3 (padded to 4), on the
    card against the CPU, float32, no kernel launched.  (Two devices'
    Adam steps would not leave the same weights: see
    ``test_unet_step_on_card_matches_cpu``.)"""
    from cswin_simam_unet_tpu_torch.serving import Server
    cpu, _ = _unet_pair(dev, True)
    _unet_step(cpu, *_uint8_batch(2, 22, 1), 1)
    card = copy.deepcopy(cpu).to(dev)
    images, masks = _uint8_batch(3, 23, 1)
    _build.reset_launches()
    got = engine.make_eval_step(card, 1)(images, masks)
    probs = Server(card)(images)
    assert not _launched()
    want = engine.make_eval_step(cpu, 1)(images, masks)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5
    assert all(abs(float(got[k]) - float(want[k])) <= 2e-3 for k in ("dice", "iou"))
    torch.testing.assert_close(probs.cpu(), Server(cpu)(images), rtol=0, atol=1e-4)


def test_unet_fit_resumed_on_card(dev, tmp_path, monkeypatch):
    """A 2-epoch augmented UNet ``fit`` on the card, checkpointed; a fresh
    model and optimizer restore epoch 1 and train epoch 2: parameters,
    running statistics and history bit for bit (cuDNN deterministic)."""
    from cswin_simam_unet_tpu_torch.train.checkpoint import CheckpointStore
    from cswin_simam_unet_tpu_torch.train.schedule import make_plateau_scheduler
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    train = [tuple(t.numpy() for t in _uint8_batch(2, s, 1)) for s in (24, 25)]
    test = [tuple(t.numpy() for t in _uint8_batch(2, 26, 1))]
    store = CheckpointStore(str(tmp_path))
    runs = []
    for seed in (30, 31):
        model = UNet(base_features=8, use_simam=True, device=dev, seed=seed)
        opt = engine.make_optimizer("adam", 1e-3, 1e-4, model.parameters())
        sched = make_plateau_scheduler(opt, 0.5, 0, 1e-7)
        runs.append((model, opt, sched))
    cfg = engine.FitConfig(num_epochs=2, plateau_patience=0, verbose=False,
                           checkpoint_manager=store)
    model, opt, sched = runs[0]
    _build.reset_launches()
    history, step = engine.fit(model, opt, train, test, cfg, scheduler=sched)
    assert not _launched() and step == 4
    fresh, opt2, sched2 = runs[1]
    sched_state, hist2, epoch, step2 = store.restore(fresh, opt2, epoch=1)
    sched2.load_state_dict(sched_state)
    hist2, step2 = engine.fit(fresh, opt2, train, test, cfg, history=hist2, scheduler=sched2,
                              start_epoch=epoch, global_step=step2)
    assert step2 == step and hist2 == history
    for (name, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert b.device.type == "cuda" and torch.equal(a, b), name
