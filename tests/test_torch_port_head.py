"""PyTorch port, the standalone flat head (kernel K5 and the F > 8 chain):
the port's plain versions against the JAX package on the CPU, with the same
numpy inputs.

JAX's ``simam_head`` runs with ``pallas_simam_head._INTERPRET = True``
(forward its ``_reference``, backward autodiff of it) and CARAFE with
``pallas_carafe._INTERPRET = True``, as the JAX package's own tests run
them; ``simam_flat`` and ``flat_grouped_dot`` are its custom VJPs.  The
port's ``simam_head`` on CPU tensors takes ``head_reference`` forward and
the closed-form plain K3 + K5 backward.  Tolerances: ops 2e-5 (float32),
modules 2e-4, each times max(1, max|JAX|) of the output compared, since
the bias and weight gradients sum over every pixel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cswin_simam_unet_tpu.ops.pallas_carafe as pc
import cswin_simam_unet_tpu.ops.pallas_simam_head as sh
from cswin_simam_unet_tpu.models import layers as jlayers
from cswin_simam_unet_tpu.ops.flat_dot import flat_grouped_dot as jflat_grouped_dot
from cswin_simam_unet_tpu.ops.simam import simam_flat as jsimam_flat

from cswin_simam_unet_tpu_torch.compat import layer_state_dict
from cswin_simam_unet_tpu_torch.models.layers import CARAFE, CARAFEHead, FusedSimAMHead
from cswin_simam_unet_tpu_torch.ops import flat_dot, simam, simam_head

TOL_OP = 2e-5
TOL_MODULE = 2e-4
G = 16


@pytest.fixture(autouse=True)
def interpret():
    old = sh._INTERPRET, pc._INTERPRET
    sh._INTERPRET = pc._INTERPRET = True
    yield
    sh._INTERPRET, pc._INTERPRET = old


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (err, tol)


def _leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def _jax_vjp(fn, args, cot):
    """(fn(*args), its VJP at cot) of a JAX function, in one jitted call."""
    def run(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)
    return jax.jit(run)([jnp.asarray(a) for a in args], jnp.asarray(cot))


def _torch_vjp(fn, inputs, cot):
    out = fn(*inputs)
    out.backward(torch.from_numpy(cot))
    return out, [t.grad for t in inputs]


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("F", [1, 4])
def test_simam_head_matches_jax(gate, F):
    B, H, W, C = 2, 8, 8, 8  # tests/test_simam_head.py's sizes
    x, b, w = _rand((B, H, W, G * C), 0), _rand((C,), 1), _rand((C, F), 2)
    dy = _rand((B, H, W, G * F), 3)
    want, grads = _jax_vjp(lambda *a: sh.simam_head(*a, G, 1e-4, gate), (x, b, w), dy)
    out, got = _torch_vjp(lambda *a: simam_head.simam_head(*a, G, 1e-4, gate),
                          _leaves(x, b, w), dy)
    _close(out, want, TOL_OP)
    for g, r in zip(got, grads):
        _close(g, r, TOL_OP)


def test_simam_flat_and_flat_grouped_dot_match_jax():
    B, H, W, C, F = 2, 4, 4, 8, 16
    x, w = _rand((B, H, W, G * C), 4), _rand((C, F), 5)
    dy, dy2 = _rand((B, H, W, G * C), 6), _rand((B, H, W, G * F), 7)
    want, (gx_want,) = _jax_vjp(lambda a: jsimam_flat(a, G), (x,), dy)
    out, (gx,) = _torch_vjp(lambda a: simam.simam_flat(a, G), _leaves(x), dy)
    _close(out, want, TOL_OP)
    _close(gx, gx_want, TOL_OP)
    want, grads = _jax_vjp(lambda a, k: jflat_grouped_dot(a, k, G), (x, w), dy2)
    out, got = _torch_vjp(lambda a, k: flat_dot.flat_grouped_dot(a, k, G), _leaves(x, w), dy2)
    _close(out, want, TOL_OP)
    for g, r in zip(got, grads):
        _close(g, r, TOL_OP)


def _head_pair(F, C, x, b, seed):
    """The JAX FusedSimAMHead and the port's with converted params."""
    jmod = jlayers.FusedSimAMHead(features=F, groups=G, use_simam=True)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                                jnp.asarray(b))["params"]
    mod = FusedSimAMHead(C, F, G)
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in layer_state_dict("conv", params).items()}, strict=True)
    return jmod, params, mod


@pytest.mark.parametrize("F", [4, 16])
def test_fused_simam_head_module_matches_jax(F):
    B, H, W, C = 1, 4, 4, 8
    x, b = _rand((B, H, W, G * C), 8), _rand((C,), 9)
    jmod, params, mod = _head_pair(F, C, x, b, F)

    def loss(p, a, c):
        return jnp.sum(jnp.sin(jmod.apply({"params": p}, a, c)))

    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x), jnp.asarray(b))
    gp, gx, gb = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(params, jnp.asarray(x),
                                                             jnp.asarray(b))
    xt, bt = _leaves(x, b)
    out = mod(xt, bt)
    torch.sin(out).sum().backward()
    _close(out, want, TOL_MODULE)
    _close(xt.grad, gx, TOL_MODULE)
    _close(bt.grad, gb, TOL_MODULE)
    _close(mod.weight.grad, np.transpose(np.asarray(gp["kernel"]), (3, 2, 0, 1)), TOL_MODULE)
    if F <= 8:  # use_kernels=False: the plain head by autograd, the same function
        _close(mod(torch.from_numpy(x), torch.from_numpy(b), use_kernels=False), want,
               TOL_MODULE)


def test_carafe_flat_raw_into_fused_head_matches_jax():
    """CARAFE(flat_output, flat_raw) -> FusedSimAMHead at 10 classes (the
    unfused chain), the JAX package's standalone flat head."""
    B, H, W, Cin, C, F = 1, 4, 4, 16, 8, 10
    x = _rand((B, H * W, Cin), 10)
    jcar = jlayers.CARAFE(dim_out=C, up_factor=4, use_pallas=True, flat_output=True,
                          flat_raw=True)
    cparams = jax.jit(jcar.init, static_argnums=(2, 3))(jax.random.PRNGKey(1),
                                                         jnp.asarray(x), H, W)["params"]
    up, bias = jax.jit(jcar.apply, static_argnums=(2, 3))({"params": cparams},
                                                          jnp.asarray(x), H, W)
    car = CARAFE(Cin, C, up_factor=4, flat_output=True, flat_raw=True)
    car.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in layer_state_dict("carafe", cparams).items()}, strict=True)
    up_t, bias_t = car(torch.from_numpy(x), H, W, kernels=True)
    _close(up_t, up, TOL_MODULE)
    _close(bias_t, bias, TOL_MODULE)
    jmod, hparams, mod = _head_pair(F, C, np.asarray(up), np.asarray(bias), 2)
    _close(mod(up_t, bias_t), jax.jit(jmod.apply)({"params": hparams}, up, bias), TOL_MODULE)


def test_carafe_head_ten_classes_matches_jax():
    B, H, W, C, F = 1, 4, 4, 8, 10
    y, enc, b = _rand((B, H, W, C), 11), _rand((B, H, W, 9 * G), 12), _rand((C,), 13)
    jmod = jlayers.CARAFEHead(features=F, up_factor=4, use_simam=True)
    jin = [jnp.asarray(a) for a in (y, enc, b)]
    params = jax.jit(jmod.init)(jax.random.PRNGKey(3), *jin)["params"]

    def loss(p, *a):
        return jnp.sum(jnp.sin(jmod.apply({"params": p}, *a)))

    want = jax.jit(jmod.apply)({"params": params}, *jin)
    gp, gy, genc, gb = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(params, *jin)
    head = CARAFEHead(C, F)
    head.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in layer_state_dict("conv", params).items()}, strict=True)
    yt, et, bt = _leaves(y, enc, b)
    out = head.flat(yt, et, bt)
    torch.sin(out).sum().backward()
    _close(out, want, TOL_MODULE)
    for got, ref in ((yt.grad, gy), (et.grad, genc), (bt.grad, gb)):
        _close(got, ref, TOL_MODULE)
    _close(head.weight.grad, np.transpose(np.asarray(gp["kernel"]), (3, 2, 0, 1)), TOL_MODULE)


def test_simam_head_rejects_wide_heads():
    x, b, w = _rand((1, 2, 2, G * 4), 14), _rand((4,), 15), _rand((4, 9), 16)
    with pytest.raises(ValueError, match="at most 8 classes"):
        sh.simam_head(jnp.asarray(x), jnp.asarray(b), jnp.asarray(w), G, 1e-4, True)
    with pytest.raises(ValueError, match="at most 8 classes"):
        simam_head.simam_head(torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(w), G)
