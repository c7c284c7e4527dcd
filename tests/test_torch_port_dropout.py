"""PyTorch port, dropout: the counter-hash keep mask, fast_dropout, DropPath,
attention dropout and the model's ``train`` argument, on the CPU in float32.

JAX draws its masks from ``jax.random``, which the port does not reproduce,
so parity with JAX at a positive rate is tested by giving the port the mask
that JAX's own function draws, rebuilt here from the same key and shape;
the port's own masks are held to keep-rate and unbiasedness statistics
(4 sigma) and, at rate 0 and in eval, the model to JAX's outputs.
Tolerances: 2e-5 for ops (forward and VJP), 2e-4 for the model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cswin_simam_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_simam_unet_tpu.models.layers import DropPath as JaxDropPath
from cswin_simam_unet_tpu.ops.attention import stripe_attention as jax_stripe_attention
from cswin_simam_unet_tpu.ops.dropout import fast_dropout as jax_fast_dropout
from cswin_simam_unet_tpu.ops.pallas_attention_flash import hash_keep_mask as jax_hash_keep_mask

from cswin_simam_unet_tpu_torch.compat import load_flax_params
from cswin_simam_unet_tpu_torch.configs import CONFIGS
from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.ops import attention, dropout, stripe_attention, windows
from cswin_simam_unet_tpu_torch.serving import Server
from cswin_simam_unet_tpu_torch.train import engine

TOL = 2e-5
TOL_MODEL = 2e-4
RATE = 0.3
TINY = dict(img_size=64, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2),
            num_heads=(2, 2, 4, 8))
DROPS = dict(drop_rate=RATE, attn_drop_rate=RATE, drop_path_rate=RATE)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _close(got, want, tol=TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=name)


# ---- the counter hash ----

def _np_hash_keep_mask(seed, g, h, qi, kj, TQ, TK, threshold):
    """pallas_attention_flash.py:126-142 transcribed to numpy uint32 (the
    int32 tile index wraps exactly as uint32 arithmetic does)."""
    u = np.uint32
    with np.errstate(over="ignore"):
        tile = ((u(g) * u(1_000_003) + u(h)) * u(4099) + u(qi)) * u(257) + u(kj)
        x = (np.arange(TQ, dtype=u)[:, None] * u(TK) + np.arange(TK, dtype=u)[None, :])
        x = x ^ (u(seed) * u(0x9E3779B9))
        x = x ^ (tile * u(0x85EBCA6B))
        x = (x ^ (x >> u(16))) * u(0x85EBCA6B)
        x = (x ^ (x >> u(13))) * u(0xC2B2AE35)
        x = x ^ (x >> u(16))
    return x >= u(threshold)


@pytest.mark.parametrize("seed,window,head,n", [
    (0, 0, 0, 16), (123456789, 1023, 3, 128), (2 ** 32 - 1, 4097, 15, 196),
    (7, 2 ** 20 + 5, 1, 256)])
def test_hash_keep_mask_is_bit_exact(seed, window, head, n):
    thr = dropout.u32_threshold(RATE)
    rows, cols = torch.arange(n)[:, None], torch.arange(n)[None, :]
    got = dropout.hash_keep_mask(seed, torch.tensor(window), torch.tensor(head), rows, cols,
                                 thr, n).numpy()
    np.testing.assert_array_equal(got, _np_hash_keep_mask(seed, window, head, 0, 0, n, n,
                                                           thr))
    bits = dropout.hash_bits(seed, torch.tensor(window), torch.tensor(head), rows, cols, n)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    if window < 2 ** 31 // 1_000_003:  # JAX's own function takes the int32 window id
        want = jax_hash_keep_mask(np.uint32(seed), jnp.int32(window), head, 0, 0, n, n, thr)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_thresholds():
    assert dropout.u16_threshold(RATE) == 19661
    assert dropout.u32_threshold(RATE) == 1288490189
    assert dropout.u32_threshold(0.0) == 0 and dropout.u32_threshold(1.0) == 2 ** 32 - 1
    assert dropout.u16_threshold(1.0) == 65535


def test_window_keep_mask_numbers_windows_like_img2windows():
    """The window index of the mask is the position in img2windows order:
    token (y, x) of image b at window (wy, wx) and in-window (ty, tx)."""
    B, H, hsp, wsp, n_heads = 2, 8, 8, 2, 2
    N, nw = hsp * wsp, H // wsp
    seed, thr = 11, dropout.u32_threshold(RATE)
    mask = dropout.window_keep_mask(seed, B * nw, n_heads, N, thr)
    ids = torch.arange(B * H * H).reshape(B, H, H, 1)
    wins = windows.img2windows(ids, hsp, wsp)[..., 0]  # (B*nw, N) image token ids
    for w in (0, 3, B * nw - 1):
        b, wx = divmod(w, nw)
        for i in (0, N - 1):
            ty, tx = divmod(i, wsp)
            assert int(wins[w, i]) == (b * H + ty) * H + wx * wsp + tx
        np.testing.assert_array_equal(
            mask[w, 1].numpy(), _np_hash_keep_mask(seed, w, 1, 0, 0, N, N, thr))


# ---- fast_dropout, DropPath and attention dropout given JAX's masks ----

def test_fast_dropout_matches_jax_given_its_mask():
    x = _rand((4, 33, 16), 1)
    key = jax.random.PRNGKey(3)
    want, vjp = jax.vjp(lambda a: jax_fast_dropout(key, a, RATE), jnp.asarray(x))
    bits = jax.random.bits(key, x.shape, jnp.uint16)
    keep = torch.from_numpy(np.array(bits >= dropout.u16_threshold(RATE)))
    xt = _t(x, grad=True)
    got = dropout.fast_dropout(xt, RATE, keep=keep)
    _close(got, want)
    g = _rand(x.shape, 2)
    _close(torch.autograd.grad(got, xt, _t(g))[0], vjp(jnp.asarray(g))[0], name="vjp")
    assert dropout.fast_dropout(xt, 0.0) is xt


def test_fast_dropout_keep_rate():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(1 << 18)
    y = dropout.fast_dropout(x, RATE, gen)
    kept = float((y != 0).float().mean())
    n = x.numel()
    want = 1 - dropout.u16_threshold(RATE) / 65536
    assert abs(kept - want) <= 4 * (want * (1 - want) / n) ** 0.5, kept
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))


def test_drop_path_matches_jax_given_its_mask(monkeypatch):
    x = _rand((8, 5, 6), 4)
    rate = 0.45
    drawn = []
    bernoulli = jax.random.bernoulli

    def record(rng, p, shape):
        drawn.append((rng, p, shape))
        return bernoulli(rng, p, shape)

    monkeypatch.setattr(jax.random, "bernoulli", record)
    key = jax.random.PRNGKey(5)
    want, vjp = jax.vjp(lambda a: JaxDropPath(rate).apply({}, a, False,
                                                          rngs={"dropout": key}),
                        jnp.asarray(x))
    (rng, p, shape), = drawn
    keep = torch.from_numpy(np.array(bernoulli(rng, p, shape))).reshape(-1)
    assert 0 < int(keep.sum()) < 8
    xt = _t(x, grad=True)
    got = dropout.drop_path(xt, rate, keep=keep)
    _close(got, want)
    g = _rand(x.shape, 6)
    _close(torch.autograd.grad(got, xt, _t(g))[0], vjp(jnp.asarray(g))[0], name="vjp")


ATTN_GEOMS = [
    # (H, split, idx, heads, C)
    (8, 2, 0, 2, 16),    # vertical stripes
    (8, 2, 1, 2, 16),    # horizontal stripes
    (8, 8, -1, 4, 32),   # global window
]


@pytest.mark.parametrize("H,split,idx,heads,C", ATTN_GEOMS)
def test_attention_dropout_matches_jax_given_its_mask(H, split, idx, heads, C):
    """ops/attention.py:99-110 draws u16 bits per score of the partitioned
    (B*nWin, heads, N, N) tensor; the port's plain attention, its autograd
    and its backward reference all take that mask."""
    hsp, wsp = windows.stripe_geometry(H, split, idx)
    q, k, v, g = (_rand((2, H * H, C), s, 0.5) for s in (10, 11, 12, 13))
    lk = _rand((3, 3, 1, C), 14, 0.3)
    key = jax.random.PRNGKey(8)
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads)
    want, vjp = jax.vjp(lambda *a: jax_stripe_attention(*a, **kw, attn_drop=RATE,
                                                        deterministic=False,
                                                        dropout_rng=key),
                        *(jnp.asarray(a) for a in (q, k, v, lk)))
    n_win = 2 * (H // hsp) * (H // wsp)
    bits = jax.random.bits(key, (n_win, heads, hsp * wsp, hsp * wsp), jnp.uint16)
    keep = torch.from_numpy(np.array(bits >= dropout.u16_threshold(RATE)))
    ins = [_t(a, grad=True) for a in (q, k, v, lk)]
    got = attention.stripe_attention(*ins, **kw, attn_drop=RATE, keep=keep)
    _close(got, want)
    want_g = vjp(jnp.asarray(g))
    got_g = torch.autograd.grad(got, ins, _t(g))
    ref_g = attention.stripe_attention_bwd_reference(*(_t(a) for a in (q, k, v, lk, g)),
                                                     **kw, attn_drop=RATE, keep=keep)
    for a, b, e, name in zip(got_g, ref_g, want_g, ("dq", "dk", "dv", "dw")):
        _close(a, e, name=name)
        _close(b, e, name=name + " (backward reference)")


@pytest.mark.parametrize("H,split,idx,heads,C", ATTN_GEOMS[:2])
def test_attention_function_drops_the_plain_mask(H, split, idx, heads, C):
    """The autograd Function (its CPU forward and backward) and the plain
    attention with the hash mask of one seed: the same values and
    gradients, and the mask really acts."""
    hsp, wsp = windows.stripe_geometry(H, split, idx)
    qkv = _rand((2, H * H, 3 * C), 20, 0.5)
    lk = _rand((3, 3, 1, C), 21, 0.3)
    g = _t(_rand((2, H * H, C), 22))
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=RATE, seed=99)
    outs, grads = [], []
    for impl in (stripe_attention.stripe_attention, attention.stripe_attention):
        qkv_t, lk_t = _t(qkv, grad=True), _t(lk, grad=True)
        out = impl(*qkv_t.chunk(3, dim=-1), lk_t, **kw)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, (qkv_t, lk_t), g))
    _close(outs[0], outs[1].numpy())
    for a, b in zip(grads[0], grads[1]):
        _close(a, b.numpy())
    no_drop = attention.stripe_attention(*_t(qkv).chunk(3, dim=-1), _t(lk),
                                         **{**kw, "attn_drop": 0.0})
    assert float((outs[1] - no_drop).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="seed"):
        attention.stripe_attention(*_t(qkv).chunk(3, dim=-1), _t(lk), **{**kw, "seed": None})


def test_attention_mask_keep_rate_and_unbiased_output():
    """Rate 0.3 over 64 windows x 2 heads x 128^2 scores: the keep rate lies
    within 4 sigma of 0.7; with q = k = 0 and v = 1 each output is the row's
    kept share / 0.7, and with random q, k, v the per-row mean difference to
    the undropped output has mean 0 within 4 standard errors."""
    H, hsp, wsp, heads, C = 128, 128, 1, 2, 16
    n_win, N = 2 * H // wsp, hsp * wsp
    keep = dropout.window_keep_mask(1234, n_win, heads, N, dropout.u32_threshold(RATE))
    n = keep.numel()
    p_keep = 1 - dropout.u32_threshold(RATE) / 2 ** 32
    rate = float(keep.float().mean())
    assert abs(rate - p_keep) <= 4 * (p_keep * (1 - p_keep) / n) ** 0.5, rate

    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=RATE, seed=1234)
    zeros, ones = torch.zeros(2, H * H, C), torch.ones(2, H * H, C)
    out = attention.stripe_attention(zeros, zeros, ones, torch.zeros(3, 3, 1, C), **kw)
    read_back = out.reshape(2, H, H, heads, C // heads)[..., 0].double().mean() * (1 - RATE)
    assert abs(float(read_back) - p_keep) <= 4 * (p_keep * (1 - p_keep) / n) ** 0.5

    q, k, v = (torch.from_numpy(_rand((2, H * H, C), s)) for s in (30, 31, 32))
    lk = torch.zeros(3, 3, 1, C)
    diff = (attention.stripe_attention(q, k, v, lk, **kw)
            - attention.stripe_attention(q, k, v, lk, **{**kw, "attn_drop": 0.0}))
    rows = diff.reshape(2, H * H, heads, C // heads).mean(-1).reshape(-1).double()
    z = float(rows.mean() / (rows.std() / rows.numel() ** 0.5))
    assert abs(z) <= 4.0, z


# ---- the model: train / eval, seeds, serving ----

def test_drop_path_schedule_matches_jax():
    depth = (1, 2, 9, 1)
    model = CSWinUNet(img_size=64, depth=depth, split_size=(1, 2, 2, 2), embed_dim=16,
                      num_heads=(2, 2, 4, 8), drop_path_rate=RATE, device="cpu")
    dpr = np.linspace(0.0, RATE, sum(depth))
    starts = np.concatenate([[0], np.cumsum(depth)])
    for s in range(4):
        want = [float(r) for r in dpr[starts[s]:starts[s + 1]]]
        for name in (f"stage{s + 1}", f"stage_up{s + 1}"):
            assert [b.drop_path for b in getattr(model, name)] == want, name


def test_configs_carry_the_drops():
    for name in ("cswin_simam_512", "cswinunet"):
        cfg = CONFIGS[name]
        assert (cfg.drop_rate, cfg.attn_drop_rate, cfg.drop_path_rate) == (RATE,) * 3
    cfg = CONFIGS["cswinunet"]
    assert (cfg.img_size, cfg.split_size, cfg.use_simam, cfg.dtype) == (
        448, (1, 2, 7, 7), False, "float32")


def test_model_eval_at_drops_matches_jax():
    """Drops 0.3 (and no SimAM) in eval: the port with train=False against
    JAX's apply with train=False, and dropout acting only with train=True."""
    jm = JaxCSWinUNet(**TINY, **DROPS, use_simam=False)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)))
    rs = np.random.RandomState(2)
    variables = jax.tree_util.tree_map(
        lambda leaf: (rs.randn(*leaf.shape) / np.sqrt(max(np.prod(leaf.shape[:-1]), 1))
                      ).astype(np.float32), shapes)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    port = CSWinUNet(**TINY, **DROPS, use_simam=False, device="cpu")
    load_flax_params(port, variables)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for use_kernels in (True, False):
            _close(port(xt, use_kernels), want, TOL_MODEL, f"use_kernels={use_kernels}")
        train = port(xt, True, train=True, rng=1)
        assert torch.equal(train, port(xt, True, train=True, rng=1))
        assert float((train - port(xt, True)).abs().max()) > 1e-3
        assert torch.equal(port(xt, False, train=True, rng=1), port(xt, False, train=True,
                                                                    rng=1))
    with pytest.raises(ValueError, match="rng"):
        port(xt, True, train=True)


def _batch():
    rs = np.random.RandomState(40)
    images = rs.randint(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    masks = (rs.randint(0, 2, (2, 64, 64, 1)) * 255).astype(np.uint8)
    return images, masks


def test_serving_after_training_step_equals_fresh_model():
    """A training step at drops 0.3 leaves no mode behind: the server of the
    trained model answers exactly as a fresh model with its weights does."""
    images, masks = _batch()
    model = CSWinUNet(**TINY, **DROPS, use_simam=True, device="cpu", seed=1)
    opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
    engine.make_train_step(model, opt, seed=4)(images, masks)
    fresh = CSWinUNet(**TINY, **DROPS, use_simam=True, device="cpu", seed=2)
    fresh.load_state_dict(model.state_dict())
    assert torch.equal(Server(model)(images), Server(fresh)(images))


def test_train_steps_from_one_seed_are_identical():
    images, masks = _batch()
    losses = {}
    for seed in (7, 7, 8):
        model = CSWinUNet(**TINY, **DROPS, use_simam=False, device="cpu", seed=1)
        opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
        step = engine.make_train_step(model, opt, seed=seed)
        losses.setdefault(seed, []).append([float(step(images, masks)["loss"])
                                            for _ in range(2)])
    assert losses[7][0] == losses[7][1]
    assert losses[7][0][0] != losses[8][0][0]
    assert losses[7][0][0] != losses[7][0][1]  # each step draws anew


def test_kernel_path_matches_plain_path_at_drops():
    """The Function path (the kernels' plain versions on the CPU) against
    autograd of the plain ops, one seed: the same masks, so the same loss
    and gradients."""
    images, masks = _batch()
    grads = []
    for use_kernels in (True, False):
        model = CSWinUNet(**TINY, **DROPS, use_simam=True, device="cpu", seed=3)
        loss, _, _ = engine.compute_gradients(model, images, masks, 1, use_kernels, rng=21)
        grads.append((float(loss), {n: p.grad for n, p in model.named_parameters()}))
    assert abs(grads[0][0] - grads[1][0]) <= 1e-6
    for name, g in grads[1][1].items():
        err = float((grads[0][1][name] - g).abs().max())
        assert err <= 5e-5 * max(float(g.abs().max()), 1e-12), (name, err)
