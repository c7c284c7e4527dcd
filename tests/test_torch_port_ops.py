"""PyTorch port, ops: the port's plain versions against the JAX package on
the CPU, in float32, with the same numpy inputs.

Where the JAX function is a Pallas kernel it runs in interpret mode, as the
JAX package's own kernel tests run it.  On the CPU the port's kernel
wrappers take their plain versions, so these tests hold the arithmetic that
the CUDA kernels are compared against on the card.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cswin_simam_unet_tpu.ops.pallas_attention_v2 as pa2
import cswin_simam_unet_tpu.ops.pallas_carafe as pc
import cswin_simam_unet_tpu.ops.pallas_carafe_head as ch
# modules, not the functions of the same names that ops/__init__ exports
jsimam = importlib.import_module("cswin_simam_unet_tpu.ops.simam")
jwin = importlib.import_module("cswin_simam_unet_tpu.ops.windows")

from cswin_simam_unet_tpu_torch.ops import attention, carafe, carafe_head, carafe_kernels
from cswin_simam_unet_tpu_torch.ops import simam, stripe_attention, windows
from cswin_simam_unet_tpu_torch.serving import Server, _coerce_uint8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5


@pytest.fixture
def interpret():
    """Pallas kernels of the JAX package in interpret mode (CPU)."""
    old = pa2._INTERPRET, pc._INTERPRET, ch._INTERPRET
    pa2._INTERPRET = pc._INTERPRET = ch._INTERPRET = True
    yield
    pa2._INTERPRET, pc._INTERPRET, ch._INTERPRET = old


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ---- (a) windows and simam ----

@pytest.mark.parametrize("S", [2, 4])
def test_pixel_shuffle_pair_matches_jax(S):
    x = _rand((2, 3, 5, S * S * 4), 0)
    np.testing.assert_array_equal(windows.pixel_shuffle(_t(x), S).numpy(),
                                  np.asarray(jwin.pixel_shuffle(jnp.asarray(x), S)))
    y = _rand((2, 3 * S, 5 * S, 4), 1)
    np.testing.assert_array_equal(windows.pixel_unshuffle(_t(y), S).numpy(),
                                  np.asarray(jwin.pixel_unshuffle(jnp.asarray(y), S)))


@pytest.mark.parametrize("hsp,wsp", [(8, 1), (2, 8), (8, 8), (4, 2)])
def test_windows_match_jax(hsp, wsp):
    x = _rand((2, 8, 8, 6), 2)
    wins = windows.img2windows(_t(x), hsp, wsp)
    np.testing.assert_array_equal(wins.numpy(),
                                  np.asarray(jwin.img2windows(jnp.asarray(x), hsp, wsp)))
    np.testing.assert_array_equal(windows.windows2img(wins, hsp, wsp, 8, 8).numpy(), x)
    tok = windows.nhwc_to_tokens(_t(x))
    assert tok.shape == (2, 64, 6)
    np.testing.assert_array_equal(windows.tokens_to_nhwc(tok, 8, 8).numpy(), x)


def test_stripe_geometry_matches_jax():
    for idx in (-1, 0, 1):
        assert windows.stripe_geometry(32, 4, idx) == jwin.stripe_geometry(32, 4, idx)
    with pytest.raises(ValueError):
        windows.stripe_geometry(32, 4, 2)
    with pytest.raises(ValueError):
        windows.tokens_to_nhwc(torch.zeros(1, 10, 2), 3, 3)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 5, 7, 3), (2, 1, 1, 4)])
def test_simam_matches_jax(shape):
    x = _rand(shape, 3, scale=2.0) + 0.5
    _close(simam.simam(_t(x)), jsimam.simam(jnp.asarray(x)))


@pytest.mark.parametrize("G", [4, 16])
def test_simam_flat_matches_jax(G):
    x = _rand((2, 4, 4, G * 8), 4)
    _close(simam.simam_flat(_t(x), G), jsimam.simam_flat(jnp.asarray(x), G))


# ---- (b) attention: the plain version of K-A against the v2 kernel ----

@pytest.mark.parametrize("H,split,idx,heads,C", [
    (8, 1, 0, 1, 8),     # width-1 vertical stripes
    (8, 2, 0, 2, 16),    # vertical
    (8, 2, 1, 2, 16),    # horizontal
    (8, 8, -1, 4, 32),   # global window
    (4, 2, 1, 1, 8),     # horizontal, one head
])
def test_stripe_attention_matches_pallas_v2(interpret, H, split, idx, heads, C):
    hsp, wsp = windows.stripe_geometry(H, split, idx)
    q, k, v = (_rand((2, H * H, C), s, 0.5) for s in (10, 11, 12))
    lk = _rand((3, 3, 1, C), 13, 0.3)
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads)
    want = pa2.stripe_attention_pallas_v2(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(lk), **kw)
    got = attention.stripe_attention(_t(q), _t(k), _t(v), _t(lk), **kw)
    _close(got, want)
    # the K-A wrapper takes the plain version for CPU tensors, strided ones too
    qkv = _t(np.concatenate([q, k, v], axis=-1))
    got_w = stripe_attention.stripe_attention(qkv[..., :C], qkv[..., C:2 * C],
                                              qkv[..., 2 * C:], _t(lk), **kw)
    _close(got_w, want)


# ---- (c) CARAFE: the plain version of K-C against the Pallas kernel ----

@pytest.mark.parametrize("B,H,W,C,S", [(2, 8, 8, 8, 2), (1, 8, 8, 8, 4), (1, 4, 8, 4, 2)])
def test_carafe_matches_pallas(interpret, B, H, W, C, S):
    x = _rand((B, H, W, C), 20)
    enc = _rand((B, H, W, 9 * S * S), 21)
    want_flat = pc.carafe_flat_pallas(jnp.asarray(x), jnp.asarray(enc), S, 3)
    _close(carafe.carafe_flat(_t(x), _t(enc), S), want_flat)
    _close(carafe_kernels.carafe_flat(_t(x), _t(enc), S), want_flat)
    want = pc.carafe_reassemble_pallas(jnp.asarray(x), jnp.asarray(enc), S, 3)
    _close(carafe.carafe_reassemble(_t(x), _t(enc), S), want)
    _close(carafe_kernels.carafe_reassemble(_t(x), _t(enc), S), want)


# ---- (d) the fused head against carafe_simam_head ----

@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("B,H,W,C,S,F", [(1, 8, 8, 8, 4, 1), (2, 4, 4, 8, 2, 3)])
def test_carafe_simam_head_matches_pallas(interpret, B, H, W, C, S, F, gate):
    x = _rand((B, H, W, C), 30)
    enc = _rand((B, H, W, 9 * S * S), 31)
    b = _rand((C,), 32, 0.1)
    w = _rand((C, F), 33)
    want = ch.carafe_simam_head(jnp.asarray(x), jnp.asarray(enc), jnp.asarray(b),
                                jnp.asarray(w), S, 3, 1e-4, gate)
    got = carafe_head.carafe_simam_head(_t(x), _t(enc), _t(b), _t(w), S, 3, 1e-4, gate)
    assert got.shape == (B, H, W, S * S * F)
    _close(got, want)


def test_carafe_simam_head_rejects_wide_heads():
    with pytest.raises(ValueError, match="at most 8"):
        carafe_head.carafe_simam_head(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 36),
                                      torch.zeros(8), torch.zeros(8, 9), 2)


# ---- (g) serving: buckets, pad and chunk, input coercion ----

class _Recorder(torch.nn.Module):
    """Stands in for the model: records batch sizes, returns a marker map."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
        self.calls = []

    @property
    def device(self):
        return self.w.device

    def predict(self, x):
        self.calls.append(x.shape[0])
        return x[..., :1] * 0.5


@pytest.mark.parametrize("n,calls", [(1, [1]), (3, [4]), (8, [8]), (11, [8, 4]),
                                     (17, [8, 8, 1])])
def test_server_pads_and_chunks(n, calls):
    model = _Recorder()
    server = Server(model)
    imgs = np.random.RandomState(n).randint(0, 256, (n, 4, 4, 3), dtype=np.uint8)
    out = server(imgs)
    assert model.calls == calls
    assert out.shape == (n, 4, 4, 1)
    np.testing.assert_allclose(out.numpy(), imgs[..., :1] / 255.0 * 0.5, rtol=1e-6)
    assert server.bucket(5) == 8 and server.bucket(2) == 2


def test_coerce_uint8_rules():
    u8 = np.arange(12, dtype=np.uint8).reshape(1, 2, 2, 3)
    assert _coerce_uint8(u8) is u8
    norm = np.array([[0.0, 0.5, 1.0]], np.float32)
    np.testing.assert_array_equal(_coerce_uint8(norm), [[0, 128, 255]])
    pix = np.array([[0.0, 17.0, 255.0]], np.float32)
    np.testing.assert_array_equal(_coerce_uint8(pix), [[0, 17, 255]])
    with pytest.raises(ValueError):
        _coerce_uint8(np.array([[0.5, 17.0]], np.float32))
    with pytest.raises(ValueError):
        _coerce_uint8(np.array([[-1.0, 3.0]], np.float32))
    assert _coerce_uint8(np.zeros((0, 2), np.float32)).dtype == np.uint8
    np.testing.assert_array_equal(_coerce_uint8(np.array([3, 7], np.int32)), [3, 7])
    t = torch.tensor([[0, 255]], dtype=torch.uint8)
    assert _coerce_uint8(t) is t
    with pytest.raises(TypeError):
        _coerce_uint8(torch.tensor([[0.0, 1.0]]))


# ---- (h) the port and chip_smoke.py import without JAX ----

def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'cswin_simam_unet_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil\n"
        "import cswin_simam_unet_tpu_torch as port\n"
        "for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not any(n == 'jax' or n.startswith(('jax.', 'flax')) for n in sys.modules"
        " if sys.modules[n] is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
