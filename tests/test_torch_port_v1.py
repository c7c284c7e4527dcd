"""PyTorch port, v1 window attention (kernels K-V1 and K-V1'): the port's
plain versions against the JAX package on the CPU, with the same numpy
inputs.

JAX's ``window_attention`` runs with ``pallas_attention._INTERPRET = True``,
which runs the Pallas kernel bodies themselves, as the JAX package's own
tests do; the port's ``window_attention`` on CPU tensors takes its plain
forward and backward.  ``stripe_attention_v1`` is held against
``stripe_attention_pallas`` at ``tests/test_pallas_attention.py``'s
geometries, a 98-token window padded to 112 among them (the key mask).
Tolerances: ops 2e-5 (float32), relative and absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cswin_simam_unet_tpu.ops.pallas_attention as pa

from cswin_simam_unet_tpu_torch.ops import attention, window_attention as wa
from cswin_simam_unet_tpu_torch.ops.windows import stripe_geometry

TOL_OP = 2e-5


@pytest.fixture(autouse=True)
def interpret():
    old = pa._INTERPRET
    pa._INTERPRET = True
    yield
    pa._INTERPRET = old


def _rand(shape, seed, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL_OP,
                               atol=TOL_OP)


def _vjp_pair(jax_fn, torch_fn, args, cot):
    """(JAX out, JAX grads, port out, port grads) of one function pair."""
    def run(args, cot):
        out, vjp = jax.vjp(jax_fn, *args)
        return out, vjp(cot)

    want, grads = jax.jit(run)([jnp.asarray(a) for a in args], jnp.asarray(cot))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = torch_fn(*leaves)
    out.backward(torch.from_numpy(cot))
    return want, grads, out, [t.grad for t in leaves]


@pytest.mark.parametrize("N,Np", [(16, 16), (98, 112)])
def test_window_attention_matches_jax(N, Np):
    G, D, scale = 4, 8, 0.3
    q, k, v, do = (_rand((G, Np, D), s) for s in range(4))
    want, grads, out, got = _vjp_pair(lambda *a: pa.window_attention(*a, scale, N),
                                      lambda *a: wa.window_attention(*a, scale, N),
                                      (q, k, v), do)
    _close(out, want)
    for g, r in zip(got, grads):
        _close(g, r)
    if N < Np:  # padded keys: no weight forward, no gradient back
        assert float(got[1][:, N:].abs().max()) == 0.0
        assert float(got[2][:, N:].abs().max()) == 0.0


@pytest.mark.parametrize("H,split,idx,heads,grads", [
    (8, 2, 0, 2, True),     # vertical stripes, N=16
    (8, 2, 1, 2, False),    # horizontal stripes
    (8, 8, -1, 4, False),   # global window, N=64
    (14, 7, 0, 2, False),   # N=98 -> padded to 112 (mask path)
    (14, 7, 1, 2, True),    # padded N, gradients
    (16, 1, 0, 1, False),   # width-1 stripes, N=16
])
def test_stripe_attention_v1_matches_jax(H, split, idx, heads, grads):
    C = 16 if grads else 32
    hsp, wsp = stripe_geometry(H, split, idx)
    q, k, v = (_rand((1, H * H, C), s) for s in (1, 2, 3))
    lepe = _rand((3, 3, 1, C), 4) * 0.2
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads)
    if not grads:
        want = jax.jit(lambda *a: pa.stripe_attention_pallas(*a, **kw))(
            *(jnp.asarray(a) for a in (q, k, v, lepe)))
        _close(wa.stripe_attention_v1(*(torch.from_numpy(a) for a in (q, k, v, lepe)), **kw),
               want)
        return
    do = _rand((1, H * H, C), 5)
    want, g_want, out, got = _vjp_pair(
        lambda a, b, c: pa.stripe_attention_pallas(a, b, c, jnp.asarray(lepe), **kw),
        lambda a, b, c: wa.stripe_attention_v1(a, b, c, torch.from_numpy(lepe), **kw),
        (q, k, v), do)
    _close(out, want)
    for g, r in zip(got, g_want):
        _close(g, r)


def test_stripe_attention_v1_dropout_fallback_is_plain(monkeypatch):
    """Attention dropout in training takes the plain path, the JAX
    function's documented fallback; no v1 call happens."""
    def refuse(*args, **kwargs):
        raise AssertionError("v1 window attention called with dropout active")

    C, H = 16, 8
    q, k, v = (torch.from_numpy(_rand((2, H * H, C), s)) for s in (6, 7, 8))
    lepe = torch.from_numpy(_rand((3, 3, 1, C), 9))
    kw = dict(H=H, W=H, hsp=H, wsp=2, num_heads=2, attn_drop=0.3, seed=1234)
    monkeypatch.setattr(wa, "window_attention", refuse)
    got = wa.stripe_attention_v1(q, k, v, lepe, deterministic=False, **kw)
    assert torch.equal(got, attention.stripe_attention(q, k, v, lepe, **kw))
    with pytest.raises(AssertionError, match="dropout active"):  # eval: the v1 path
        wa.stripe_attention_v1(q, k, v, lepe, **kw)


def test_window_attention_rejects_long_windows():
    x = torch.zeros(1, 2064, 8)
    with pytest.raises(ValueError, match="at most 2048 tokens"):
        wa.window_attention(x, x, x, 1.0, 2050)
