"""PyTorch port, long windows: the plain flash path against the JAX flash
kernels, on the CPU in float32.

JAX's ``stripe_attention_pallas_flash`` runs in interpret mode, as
``tests/test_pallas_attention_flash.py`` runs it; the port's
``stripe_attention_flash`` takes its plain versions for CPU tensors, which
are what the CUDA kernels are held against on the card.  Tolerance 2e-5
(absolute and relative), as for the port's other ops.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cswin_simam_unet_tpu.ops.pallas_attention_flash as paf
from cswin_simam_unet_tpu.configs import CONFIGS as JAX_CONFIGS
from cswin_simam_unet_tpu.models.layers import LePEAttention as JaxLePEAttention
from cswin_simam_unet_tpu.ops.windows import stripe_geometry

from cswin_simam_unet_tpu_torch.configs import CONFIGS, TRAIN_CONFIGS
from cswin_simam_unet_tpu_torch.models.layers import LePEAttention
from cswin_simam_unet_tpu_torch.ops import dropout, flash_attention, stripe_attention

TOL = 2e-5
RATE = 0.3


@pytest.fixture
def interpret():
    old = paf._INTERPRET
    paf._INTERPRET = True
    yield
    paf._INTERPRET = old


def _rand(shape, seed, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=name)


def _loss_jax(o):
    return jnp.sum(o * jnp.cos(o))


def _loss(o):
    return (o * torch.cos(o)).sum()


# (H, split, idx, heads): a 32^2 global window (1024 tokens, 2 x 2 tiles of
# 512) and 8-wide vertical stripes (the flip path, 256 tokens per band)
@pytest.mark.parametrize("H,split,idx,heads", [(32, 32, -1, 2), (32, 8, 0, 2)])
def test_flash_path_matches_jax_flash(interpret, H, split, idx, heads):
    """Forward and VJP of q, k, v and the LePE kernel through the port's
    flash path, which serves any stripe or global window."""
    C = 16
    hsp, wsp = stripe_geometry(H, split, idx)
    q, k, v = (_rand((1, H * H, C), s) for s in (1, 2, 3))
    lk = _rand((3, 3, 1, C), 4, 0.2)
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads)

    def jax_fn(q, k, v, lk):
        return _loss_jax(paf.stripe_attention_pallas_flash(q, k, v, lk, **kw))

    args = [jnp.asarray(a) for a in (q, k, v, lk)]
    want = paf.stripe_attention_pallas_flash(*args, **kw)
    want_grads = jax.grad(jax_fn, argnums=(0, 1, 2, 3))(*args)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, lk)]
    got = flash_attention.stripe_attention_flash(*ts, **kw)
    _close(got, want)
    _loss(got).backward()
    for t, g, name in zip(ts, want_grads, "q k v lepe".split()):
        _close(t.grad, g, name=name)


def test_flash_reference_backward_matches_autograd_with_dropout():
    """The plain flash backward with the flash mask against autograd of the
    plain flash forward (same mask): the two halves of the CPU path agree
    at rate 0.3, where JAX's interpret mode has no kernel to compare."""
    G, N, C, heads = 2, 1024, 16, 2
    qb, kb, vb = (torch.from_numpy(_rand((G, N, C), s)).requires_grad_() for s in (5, 6, 7))
    kw = dict(heads=heads, attn_drop=RATE, seed=2 ** 31 + 3)
    out, lse = flash_attention.flash_attention_reference(qb, kb, vb, **kw)
    dout = torch.from_numpy(_rand((G, N, C), 8))
    want = torch.autograd.grad(out, (qb, kb, vb), dout)
    got = flash_attention.flash_attention_bwd_reference(qb, kb, vb, out.detach(), lse, dout,
                                                         **kw)
    for g, w, name in zip(got, want, "q k v".split()):
        _close(g, w, name=name)
    nodrop, _ = flash_attention.flash_attention_reference(qb, kb, vb, heads=heads)
    assert float((out - nodrop).abs().max().detach()) > 1e-2


@pytest.mark.parametrize("seed,g,h,qi,kj,T", [
    (0, 0, 0, 0, 0, 512), (123456789, 3, 15, 7, 2, 512), (2 ** 32 - 1, 1, 1, 1, 0, 256),
    (7, 11, 5, 0, 3, 128)])
def test_flash_keep_mask_is_bit_exact(seed, g, h, qi, kj, T):
    """The plain flash path's mask, tile (qi, kj) of edge T of band g and
    head h, against ``pallas_attention_flash.hash_keep_mask`` itself."""
    thr = dropout.u32_threshold(RATE)
    rows = torch.arange(qi * T, (qi + 1) * T)[:, None]
    cols = torch.arange(kj * T, (kj + 1) * T)[None, :]
    got = dropout.hash_keep_mask(seed, torch.tensor(g), torch.tensor(h), rows, cols, thr, T)
    want = paf.hash_keep_mask(np.uint32(seed), jnp.int32(g), h, jnp.int32(qi), jnp.int32(kj),
                              T, T, thr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flash_keep_mask_is_in_band_order_for_vertical_stripes():
    """A vertical stripe is a band of the transposed grid: image pixel
    (y, x) of stripe w is band token (x - w * wsp) * H + y, and the flash
    path drops score (i, j) by the mask of those band tokens."""
    H, wsp, C, heads, seed = 64, 1, 8, 1, 99
    kw = dict(H=H, W=H, hsp=H, wsp=wsp, num_heads=heads)
    assert flash_attention.band_geometry(H, H, H, wsp) == (True, H, H, wsp)
    # q = k = 0 and v = one-hot of the image pixel: row i of the output shows
    # which keys of its stripe were kept (times 1 / (1 - rate) / N)
    N = H * wsp
    v = torch.zeros(1, H * H, C)
    q = torch.zeros(1, H * H, C)
    stripe = 5
    pixels = [y * H + stripe for y in range(H)]  # stripe 5's pixels, in image order
    for n, pix in enumerate(pixels[:C]):
        v[0, pix, n] = 1.0
    out = flash_attention.stripe_attention_flash(q, q, v, torch.zeros(3, 3, 1, C), **kw,
                                                 attn_drop=RATE, seed=seed)
    T = flash_attention.pick_tile(N)
    assert T == N  # one tile: band g = stripe, head 0, tile (0, 0)
    keep = paf.hash_keep_mask(np.uint32(seed), jnp.int32(stripe), 0, jnp.int32(0),
                              jnp.int32(0), T, T, dropout.u32_threshold(RATE))
    got = out[0, pixels, :] * N * (1 - RATE)  # the keys that carry a one-hot
    np.testing.assert_allclose(got.numpy(), np.asarray(keep)[:, :C].astype(np.float32),
                               atol=1e-5)


def test_pick_tile_matches_jax():
    for n in (8, 196, 256, 500, 512, 1000, 1024, 2048, 4096, 16384, 7, 13):
        assert flash_attention.pick_tile(n) == paf._pick_tile(n), n


def test_lepe_attention_global_4096_matches_jax(interpret):
    """One LePEAttention layer with a 64^2 global window (4096 tokens: the
    flash path on both sides), use_pallas=True in interpret mode, forward
    and the VJP of its inputs and parameters."""
    H, dim, heads = 64, 16, 2
    jl = JaxLePEAttention(dim=dim, resolution=H, idx=-1, split_size=H, num_heads=heads,
                          use_pallas=True)
    q, k, v = (_rand((1, H * H, dim), s) for s in (11, 12, 13))
    params = {"get_v_kernel": jnp.asarray(_rand((3, 3, 1, dim), 14, 0.3)),
              "get_v_bias": jnp.asarray(_rand((dim,), 15, 0.1))}

    def jax_fn(q, k, v, params):
        return _loss_jax(jl.apply({"params": params}, q, k, v))

    args = [jnp.asarray(a) for a in (q, k, v)]
    want = jl.apply({"params": params}, *args)
    want_grads = jax.grad(jax_fn, argnums=(0, 1, 2, 3))(*args, params)
    layer = LePEAttention(dim, H, -1, H, heads)
    with torch.no_grad():
        layer.get_v.weight.copy_(torch.from_numpy(
            np.array(params["get_v_kernel"]).transpose(3, 2, 0, 1)))
        layer.get_v.bias.copy_(torch.from_numpy(np.array(params["get_v_bias"])))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = layer(*ts, kernels=True)
    _close(got, want)
    _loss(got).backward()
    for t, g, name in zip(ts, want_grads[:3], "q k v".split()):
        _close(t.grad, g, name=name)
    _close(layer.get_v.weight.grad.permute(2, 3, 1, 0), want_grads[3]["get_v_kernel"],
           name="get_v_kernel")
    _close(layer.get_v.bias.grad, want_grads[3]["get_v_bias"], name="get_v_bias")


def test_dispatch_by_window_size():
    """The kernels' choice at every window of the long configs: whole-window
    K-A/K-A' up to 384 tokens at head dim 32, tiled up to 2048, flash above."""
    assert stripe_attention.whole_window(256, 32) and stripe_attention.whole_window(384, 32)
    assert not stripe_attention.whole_window(385, 32)
    assert not stripe_attention.whole_window(512, 32)
    assert not stripe_attention.whole_window(256, 64)
    assert flash_attention.FLASH_MIN_TOKENS == 2048


@pytest.mark.parametrize("name", ["cswin_simam_1024", "cswin_simam_2048"])
def test_long_configs_match_jax(name):
    jc = JAX_CONFIGS[name]
    cfg, tcfg = CONFIGS[name], TRAIN_CONFIGS[name]
    m = jc.model
    assert (cfg.img_size, cfg.num_classes, cfg.in_chans) == (jc.image_size, m.n_classes,
                                                            m.in_channels)
    for field in ("embed_dim", "depth", "split_size", "num_heads", "mlp_ratio", "qkv_bias",
                  "drop_rate", "attn_drop_rate", "drop_path_rate", "use_simam", "dtype"):
        assert getattr(cfg, field) == getattr(m, field), field
    assert m.use_pallas
    assert (tcfg.optimizer, tcfg.learning_rate, tcfg.weight_decay, tcfg.batch_size) == (
        jc.optimizer, jc.learning_rate, jc.weight_decay, jc.batch_size)
