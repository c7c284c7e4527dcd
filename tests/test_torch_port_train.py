"""PyTorch port, training: the plain backward versions of K-A', K-C', K3 and
K4, the autograd Functions around the kernels, AdamW and the training step,
against the JAX package on the CPU in float32, with the same numpy inputs.

Where the JAX function is a Pallas kernel it runs in interpret mode, as the
JAX package's own kernel tests run it.  On the CPU the port's autograd
Functions take their plain forward and backward versions, so these tests
hold the arithmetic that the CUDA kernels are compared against on the card.
Tolerances: 5e-5 x max(1, max|ref|) for the backward ops, 1e-6 for AdamW,
1e-4 for losses and metrics of the training step and 5e-5 x max|g| per leaf
for its first gradients, except ``merge3.conv.weight`` (see GRAD_TOL).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cswin_simam_unet_tpu.ops.pallas_attention_v2 as pa2
import cswin_simam_unet_tpu.ops.pallas_carafe as pc
import cswin_simam_unet_tpu.ops.pallas_carafe_head as ch
from cswin_simam_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_simam_unet_tpu.ops.pallas_simam_head import _kron_eye, head_bwd1_pallas
from cswin_simam_unet_tpu.train.engine import TrainState
from cswin_simam_unet_tpu.train.engine import make_optimizer as jax_make_optimizer
from cswin_simam_unet_tpu.train.engine import make_train_step as jax_make_train_step
from cswin_simam_unet_tpu.train.losses import segmentation_loss as jax_loss

from cswin_simam_unet_tpu_torch.compat import cswin_state_dict, load_flax_params
from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.ops import attention, carafe, carafe_head, carafe_kernels
from cswin_simam_unet_tpu_torch.ops import stripe_attention, windows
from cswin_simam_unet_tpu_torch.train import engine, losses, metrics

TOL_OP = 5e-5
LAM = 1e-4
TINY = dict(img_size=64, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2),
            num_heads=(2, 2, 4, 8))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops: the test workers
    share the machine's cores, and torch's default of a thread a core in
    each worker makes those ops wait on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _close(got, want, tol=TOL_OP, name=""):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


@pytest.fixture
def attn_interpret():
    old = pa2._INTERPRET
    pa2._INTERPRET = True
    yield
    pa2._INTERPRET = old


@pytest.fixture
def carafe_interpret():
    old = pc._INTERPRET
    pc._INTERPRET = True
    yield
    pc._INTERPRET = old


@pytest.fixture
def head_interpret():
    """As tests/test_carafe_head.py: the head's kernels in interpret mode,
    ``pallas_carafe._INTERPRET`` left False (its indicator-matmul branch is
    exact under interpret and is the branch the TPU runs)."""
    old, old_pc = ch._INTERPRET, pc._INTERPRET
    ch._INTERPRET = True
    yield
    ch._INTERPRET, pc._INTERPRET = old, old_pc


# ---- K-A': stripe attention backward ----

ATTN_GEOMS = [
    # (H, split, idx, heads, C)
    (8, 2, 0, 2, 16),    # vertical stripes
    (8, 2, 1, 2, 16),    # horizontal stripes
    (8, 1, 0, 1, 8),     # width-1 vertical stripes
    (8, 8, -1, 4, 32),   # global window
]


@pytest.mark.parametrize("H,split,idx,heads,C", ATTN_GEOMS)
def test_attention_bwd_reference_matches_pallas_v2(attn_interpret, H, split, idx, heads, C):
    hsp, wsp = windows.stripe_geometry(H, split, idx)
    q, k, v, g = (_rand((2, H * H, C), s, 0.5) for s in (40, 41, 42, 43))
    lk = _rand((3, 3, 1, C), 44, 0.3)
    scale = (C // heads) ** -0.5
    want = pa2._branch_bwd_impl(*(jnp.asarray(a) for a in (q, k, v, lk)),
                                jnp.zeros((1,), jnp.int32), jnp.asarray(g), H, H, hsp, wsp,
                                heads, scale, 0.0)
    got = attention.stripe_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(lk), _t(g), H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads)
    for a, b, name in zip(got, want, ("dq", "dk", "dv", "dw")):
        assert a.shape == b.shape, name
        _close(a, b, name=name)


@pytest.mark.parametrize("H,split,idx,heads,C", ATTN_GEOMS[:2] + ATTN_GEOMS[3:])
def test_attention_function_grads_match_jax(attn_interpret, H, split, idx, heads, C):
    """Gradients through the autograd Function, with q, k, v as strided
    thirds of one qkv tensor as the model passes them."""
    hsp, wsp = windows.stripe_geometry(H, split, idx)
    qkv = _rand((2, H * H, 3 * C), 50, 0.5)
    lk = _rand((3, 3, 1, C), 51, 0.3)
    g = _rand((2, H * H, C), 52)
    kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=heads)

    def f(qkv_, lk_):
        q, k, v = jnp.split(qkv_, 3, axis=-1)
        return pa2.stripe_attention_pallas_v2(q, k, v, lk_, **kw)

    _, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(lk))
    want = vjp(jnp.asarray(g))
    qkv_t, lk_t = _t(qkv, grad=True), _t(lk, grad=True)
    out = stripe_attention.stripe_attention(*qkv_t.chunk(3, dim=-1), lk_t, **kw)
    got = torch.autograd.grad(out, (qkv_t, lk_t), _t(g))
    _close(got[0], want[0], name="dqkv")
    _close(got[1], want[1], name="dw")


# ---- K-C': CARAFE backward ----

@pytest.mark.parametrize("B,H,W,C,S", [(2, 8, 8, 8, 2), (1, 6, 5, 4, 4), (1, 4, 8, 16, 2)])
def test_carafe_bwd_reference_matches_pallas(carafe_interpret, B, H, W, C, S):
    x = _rand((B, H, W, C), 60)
    enc = _rand((B, H, W, 9 * S * S), 61)
    dacc = _rand((B, H, W, S * S * C), 62)
    want = pc._carafe_bwd(S, 3, (jnp.asarray(x), jnp.asarray(enc)), jnp.asarray(dacc))
    got = carafe.carafe_bwd_reference(_t(x), _t(enc), _t(dacc), S)
    _close(got[0], want[0], name="dx")
    _close(got[1], want[1], name="denc")


@pytest.mark.parametrize("B,H,W,C,S", [(2, 8, 8, 8, 2), (1, 8, 8, 4, 4)])
def test_carafe_function_grads_match_jax(carafe_interpret, B, H, W, C, S):
    x = _rand((B, H, W, C), 63)
    enc = _rand((B, H, W, 9 * S * S), 64)
    g = _rand((B, H * S, W * S, C), 65)
    _, vjp = jax.vjp(lambda a, e: pc.carafe_reassemble_pallas(a, e, S, 3),
                     jnp.asarray(x), jnp.asarray(enc))
    want = vjp(jnp.asarray(g))
    xt, et = _t(x, grad=True), _t(enc, grad=True)
    out = carafe_kernels.carafe_reassemble(xt, et, S)
    got = torch.autograd.grad(out, (xt, et), _t(g))
    _close(got[0], want[0], name="dx")
    _close(got[1], want[1], name="denc")


# ---- K3 and K4: the fused head's backward ----

HEAD_GEOMS = [
    # (B, H, W, C, S, F)
    (1, 8, 8, 8, 4, 1),    # the flagship's S=4 binary head
    (1, 8, 8, 8, 2, 3),    # several classes
]


def _head_inputs(B, H, W, C, S, F, seed):
    return (_rand((B, H, W, C), seed), _rand((B, H, W, 9 * S * S), seed + 1),
            _rand((C,), seed + 2, 0.1), _rand((C, F), seed + 3),
            _rand((B, H, W, S * S * F), seed + 4))


@pytest.mark.parametrize("B,H,W,C,S,F", HEAD_GEOMS)
def test_head_bwd_references_match_pallas(head_interpret, B, H, W, C, S, F):
    x, enc, b, w, dy = _head_inputs(B, H, W, C, S, F, 70)
    G = S * S
    fb, mu, v = ch._carafe_biased_moments(jnp.asarray(x), jnp.asarray(enc),
                                          jnp.tile(jnp.asarray(b), G), S, True, True)
    kwt = _kron_eye(jnp.asarray(w).T, G, jnp.float32)
    A, Bq, dW = head_bwd1_pallas(fb, jnp.asarray(dy), mu, v, jnp.zeros((G * C,)), kwt,
                                 G, C, F, LAM, interpret=True)
    mu_t, v_t = _t(np.asarray(mu)[:, :C]), _t(np.asarray(v)[:, :C])
    got = carafe_head.head_bwd1_reference(_t(fb), _t(dy), mu_t, v_t, _t(w), G, LAM)
    _close(got[0], np.asarray(A)[:, :C], name="A")
    _close(got[1], np.asarray(Bq)[:, :C], name="B")
    _close(got[2], dW, name="dW")

    want = ch._fused_bwd_call(jnp.asarray(x), jnp.asarray(enc), fb, jnp.asarray(dy), mu, v,
                              A, Bq, kwt, S, LAM, G, F, True, True)
    got = carafe_head.fused_head_bwd_reference(_t(x), _t(enc), _t(fb), _t(dy), mu_t, v_t,
                                               _t(np.asarray(A)[:, :C]),
                                               _t(np.asarray(Bq)[:, :C]), _t(w), S, LAM)
    for a, e, name in zip(got, want, ("dx", "denc", "db")):
        _close(a, e, name=name)


@pytest.mark.parametrize("gate,B,H,W,C,S,F", [(True, *HEAD_GEOMS[0]), (False, *HEAD_GEOMS[1])],
                         ids=["simam", "plain"])
def test_head_function_grads_match_jax(head_interpret, gate, B, H, W, C, S, F):
    x, enc, b, w, dy = _head_inputs(B, H, W, C, S, F, 80)
    _, vjp = jax.vjp(lambda *a: ch.carafe_simam_head(*a, S, 3, LAM, gate),
                     *(jnp.asarray(a) for a in (x, enc, b, w)))
    want = vjp(jnp.asarray(dy))
    ins = [_t(a, grad=True) for a in (x, enc, b, w)]
    out = carafe_head.carafe_simam_head(*ins, S, 3, LAM, gate)
    got = torch.autograd.grad(out, ins, _t(dy))
    for a, e, name in zip(got, want, ("dx", "denc", "dbias", "dw")):
        _close(a, e, name=name)


# ---- losses, metrics, AdamW ----

def test_loss_and_metrics_match_jax():
    from cswin_simam_unet_tpu.train import metrics as jm
    logits = _rand((2, 4, 4, 16), 90, 3.0)
    targets = (np.random.RandomState(91).rand(2, 4, 4, 16) > 0.5).astype(np.float32)
    targets[0, 0, 0] = 0.5  # soft targets, as resized masks have
    _close(losses.segmentation_loss(_t(logits), _t(targets)),
           jax_loss(jnp.asarray(logits), jnp.asarray(targets)), 1e-6)
    preds = metrics.threshold_predictions(_t(logits), 0.0)
    jpreds = jm.threshold_predictions(jnp.asarray(logits), 0.0)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
    assert float(metrics.threshold_predictions(torch.zeros(3), 0.0).sum()) == 0.0
    for fn, jfn in ((metrics.dice_coefficient, jm.dice_coefficient),
                    (metrics.iou_score, jm.iou_score)):
        _close(fn(preds, _t(targets)), jfn(jpreds, jnp.asarray(targets)), 1e-6)
    # several classes: softmax cross-entropy over the last axis, as in JAX
    labels = np.random.RandomState(94).randint(0, 16, (2, 4, 4))
    _close(losses.segmentation_loss(_t(logits), torch.from_numpy(labels), n_classes=16),
           jax_loss(jnp.asarray(logits), jnp.asarray(labels), 16), 1e-6)


def test_adamw_matches_jax():
    rs = np.random.RandomState(92)
    w0 = rs.randn(5, 3).astype(np.float32)
    grads = [rs.randn(5, 3).astype(np.float32) for _ in range(3)]
    p = torch.nn.Parameter(_t(w0.copy()))
    opt = engine.make_optimizer("adamw", 1e-3, 1e-4, [p])
    tx = jax_make_optimizer("adamw", 1e-3, 1e-4)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    for g in grads:
        p.grad = _t(g)
        opt.step()
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = {"w": params["w"] + updates["w"]}
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        engine.make_optimizer("sgd", 1e-3, 1e-4, [p])


# ---- the training step: tiny CSWin-SimAM-UNet, 3 steps ----

LR, WD, STEPS = 1e-3, 1e-4, 3
# first-step gradients, x max|g| of the leaf.  merge3's conv feeds SimAM over
# a 2x2 map (n = 3) and then LayerNorm, both with raw-moment float32
# statistics, which amplify float32 rounding: its gradient differs from
# JAX's by 1.9e-4 x max|g| on the plain path as well (autograd of stock
# torch ops, none of the port's Functions), so it is held at 5e-4; every
# other leaf agrees within 3.6e-5.  That gap is rounding, not a port fault:
# in float64 on both sides the port and JAX agree within 1e-10 x max|g| on
# every leaf, this one included (test_merge3_gap_is_float32_rounding; 2.0e-13
# measured), while each float32 run lies 0.6e-4 (JAX) and 1.3e-4 (port) x
# max|g| from that float64 gradient.  test_kernel_path_grads_match_plain
# holds the leaf, like all others, at 5e-5 between the port's two paths.
GRAD_TOL = {"merge3.conv.weight": 5e-4}
GRAD_TOL_F64 = 1e-10


def _flax_variables(jm, rs):
    """Flax variables (traced, not compiled; values from a numpy seed)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        noise = rs.randn(*leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * noise
        if "bias" in name:
            return 0.05 * noise
        return (noise / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _disc_batch(rs):
    images = rs.randint(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:64, :64]
    masks = np.stack([((yy - 20 - 8 * i) ** 2 + (xx - 30) ** 2 < 300) for i in range(2)])
    return images, (masks[..., None] * 255).astype(np.uint8)


def _jax_grads(jm, params, images, masks, dtype=jnp.float32):
    """First-step gradients of the JAX model's training loss."""
    from cswin_simam_unet_tpu.ops.windows import pixel_unshuffle

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(images, dtype) / 255.0,
                          train=True, flat_logits=True)
        return jax_loss(logits, pixel_unshuffle(jnp.asarray(masks, dtype) / 255.0, 4))

    return jax.jit(jax.grad(loss_fn))(params)


_JAX_RUNS = {}


def _jax_run(use_simam: bool):
    """Flax variables, a uint8 batch, the JAX step's metrics over 3 steps and
    the first step's gradients, drops 0.  ``use_pallas=False`` (the JAX
    package's plain reference) takes the same flat-logit path as its Pallas
    head.  Computed once per configuration."""
    if use_simam not in _JAX_RUNS:
        jm = JaxCSWinUNet(**TINY, use_simam=use_simam)
        rs = np.random.RandomState(93)
        variables = _flax_variables(jm, rs)
        images, masks = _disc_batch(rs)
        tx = jax_make_optimizer("adamw", LR, WD)
        state = TrainState.create(apply_fn=jm.apply, params=variables["params"], tx=tx)
        step = jax_make_train_step(jm, n_classes=1, donate=False)
        grads = _jax_grads(jm, variables["params"], images, masks)
        history = []
        for i in range(STEPS):
            state, m = step(state, images, masks, jax.random.PRNGKey(i))
            history.append({k: float(v) for k, v in m.items()})
        _JAX_RUNS[use_simam] = (variables, images, masks, history, grads)
    return _JAX_RUNS[use_simam]


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run(True)


@pytest.mark.parametrize("use_simam,use_kernels", [
    (True, True), (True, False), (False, True), (False, False)],
    ids=["kernels", "plain", "nosimam-kernels", "nosimam-plain"])
def test_train_steps_match_jax(use_simam, use_kernels):
    """Drops 0, SimAM on (the flagship's head) and off (``cswinunet``'s)."""
    variables, images, masks, history, grads = _jax_run(use_simam)
    port = CSWinUNet(**TINY, use_simam=use_simam, device="cpu")
    load_flax_params(port, variables)
    opt = engine.make_optimizer("adamw", LR, WD, port.parameters())
    step = engine.make_train_step(port, opt, use_kernels=use_kernels)
    for i, want in enumerate(history):
        got = {k: float(v) for k, v in step(images, masks).items()}
        for key in ("loss", "dice", "iou"):
            assert abs(got[key] - want[key]) <= 1e-4, (i, key, got[key], want[key])
        if i == 0:
            want_g = cswin_state_dict({"params": grads}, TINY["depth"])
            named = dict(port.named_parameters())
            assert set(named) == set(want_g)
            for name, g in want_g.items():
                g = np.asarray(g)
                err = float(np.abs(named[name].grad.numpy() - g).max())
                tol = GRAD_TOL.get(name, 5e-5) * max(float(np.abs(g).max()), 1e-12)
                assert err <= tol, (name, err, tol)
    assert history[-1]["loss"] < history[0]["loss"]


def test_kernel_path_grads_match_plain(jax_run):
    """The port's Function path (custom backward versions) against its plain
    path (autograd of stock torch ops) on the same weights and batch."""
    variables, images, masks, _, _ = jax_run
    grads = []
    for use_kernels in (True, False):
        port = CSWinUNet(**TINY, use_simam=True, device="cpu")
        load_flax_params(port, variables)
        opt = engine.make_optimizer("adamw", LR, WD, port.parameters())
        engine.make_train_step(port, opt, use_kernels=use_kernels)(images, masks)
        grads.append({n: p.grad for n, p in port.named_parameters()})
    for name, g in grads[1].items():
        err = float((grads[0][name] - g).abs().max())
        assert err <= 5e-5 * max(float(g.abs().max()), 1e-12), (name, err)


class _WideFloat:
    """A stand-in for ``jax.numpy`` whose ``float32`` is float64."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(self._module, name)


_F32_CASTING_MODULES = ("ops.simam", "ops.carafe", "ops.attention", "ops.pallas_layernorm",
                        "train.losses")


def test_merge3_gap_is_float32_rounding(monkeypatch):
    """The first-step gradients of the SimAM model in float64 on both sides:
    JAX under ``jax.enable_x64`` with float64 parameters and compute dtype,
    the port with float64 parameters and compute dtype.  Both sides compute
    their statistics in float32 on purpose (SimAM, LayerNorm, softmax, CARAFE
    taps, the loss); for this test each such float32 is widened to float64 on
    both sides (the JAX modules' ``jnp.float32`` and torch's
    ``Tensor.float``), so nothing rounds to float32.  Every leaf then agrees
    within 1e-10 x max|g|, ``merge3.conv.weight`` included: its 1.9e-4 gap in
    float32 (GRAD_TOL) is rounding."""
    import importlib
    rs = np.random.RandomState(93)
    variables = _flax_variables(JaxCSWinUNet(**TINY, use_simam=True), rs)
    jm = JaxCSWinUNet(**TINY, use_simam=True, dtype=jnp.float64)
    images, masks = _disc_batch(rs)
    for name in _F32_CASTING_MODULES:
        module = importlib.import_module(f"cswin_simam_unet_tpu.{name}")
        monkeypatch.setattr(module, "jnp", _WideFloat(module.jnp))
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        variables["params"])
        grads = _jax_grads(jm, params, images, masks, jnp.float64)
        want = {k: np.asarray(v) for k, v in
                cswin_state_dict({"params": grads}, TINY["depth"]).items()}
    assert all(v.dtype == np.float64 for v in want.values())

    port = CSWinUNet(**TINY, use_simam=True, device="cpu", dtype=torch.float64).double()
    port.load_state_dict({k: torch.from_numpy(np.array(v, np.float64)) for k, v in
                          cswin_state_dict(variables, TINY["depth"]).items()})
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    engine.compute_gradients(port, images, masks, use_kernels=False)
    monkeypatch.undo()
    for name, p in port.named_parameters():
        g = want[name]
        err = float(np.abs(p.grad.numpy() - g).max())
        assert err <= GRAD_TOL_F64 * max(float(np.abs(g).max()), 1e-30), (name, err)


def test_train_step_rejects_what_is_not_ported():
    port = CSWinUNet(**TINY, use_simam=True, device="cpu")
    opt = engine.make_optimizer("adamw", LR, WD, port.parameters())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.make_train_step(port, opt, augment=object())
    with pytest.raises(ValueError, match="grad_accum"):
        engine.make_train_step(port, opt, grad_accum=0)
    step = engine.make_train_step(port, opt)
    with pytest.raises(TypeError, match="uint8"):
        step(np.zeros((1, 64, 64, 3), np.float32), np.zeros((1, 64, 64, 1), np.uint8))
