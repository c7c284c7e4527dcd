"""PyTorch port, LayerNorm (kernels K-LN and K-LN'): the port's plain
versions against the JAX package on the CPU, with the same numpy inputs.

JAX's ``layer_norm`` runs with ``pallas_layernorm._INTERPRET = True``, as
the JAX package's own tests run it (forward ``_ln_reference``, backward
autodiff of it); the port's ``layer_norm`` on CPU tensors takes
``ln_reference`` and the TPU kernel's closed-form backward.  The two
backward formulas agree where the variance is positive, which randn rows
have (a constant row clamps to variance 0, where autodiff of the clamp and
the kernel's formula differ on both sides alike).  Tolerances: ops 2e-5
(float32), modules 2e-4, both relative and absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cswin_simam_unet_tpu.ops.pallas_layernorm as pln
from cswin_simam_unet_tpu.models.layers import FusedLayerNorm as JaxFusedLayerNorm

from cswin_simam_unet_tpu_torch.compat import layer_state_dict
from cswin_simam_unet_tpu_torch.models.layers import FusedLayerNorm
from cswin_simam_unet_tpu_torch.ops import layernorm

TOL_OP = 2e-5
TOL_MODULE = 2e-4


@pytest.fixture(autouse=True)
def interpret():
    old = pln._INTERPRET
    pln._INTERPRET = True
    yield
    pln._INTERPRET = old


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("M,C", [(48, 64), (40, 96)])
def test_layer_norm_matches_jax(M, C):
    x, dy = _rand((M, C), 0, 2.0, 0.5), _rand((M, C), 3)
    scale, bias = _rand((C,), 1, 0.3, 1.0), _rand((C,), 2, 0.1)
    def run(args, cot):
        out, vjp = jax.vjp(lambda a, s, b: pln.layer_norm(a, s, b, 1e-5), *args)
        return out, vjp(cot)

    want, (gx, gs, gb) = jax.jit(run)([jnp.asarray(a) for a in (x, scale, bias)],
                                      jnp.asarray(dy))
    xt, st, bt = (torch.tensor(a, requires_grad=True) for a in (x, scale, bias))
    y = layernorm.layer_norm(xt, st, bt, 1e-5)
    y.backward(torch.from_numpy(dy))
    _close(y, want, TOL_OP)
    for got, ref in ((xt.grad, gx), (st.grad, gs), (bt.grad, gb)):
        _close(got, ref, TOL_OP)


def test_fused_layer_norm_module_matches_jax():
    C = 64
    x = _rand((2, 24, C), 4)
    jmod = JaxFusedLayerNorm(use_pallas=True)
    params = {"scale": jnp.asarray(_rand((C,), 5, 0.3, 1.0)),
              "bias": jnp.asarray(_rand((C,), 6, 0.1))}

    def loss(p, a):
        return jnp.sum(jnp.sin(jmod.apply({"params": p}, a)))

    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    mod = FusedLayerNorm(C, use_kernel=True)
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in layer_state_dict("norm", params).items()}, strict=True)
    xt = torch.tensor(x, requires_grad=True)
    y = mod(xt)
    torch.sin(y).sum().backward()
    _close(y, want, TOL_MODULE)
    _close(xt.grad, g_x, TOL_MODULE)
    _close(mod.weight.grad, g_params["scale"], TOL_MODULE)
    _close(mod.bias.grad, g_params["bias"], TOL_MODULE)
    # the plain path (use_kernel off, the model's default) computes the same
    off = FusedLayerNorm(C)
    off.load_state_dict(mod.state_dict())
    _close(off(torch.from_numpy(x)), want, TOL_MODULE)


def test_layer_norm_bf16_dtypes():
    C = 96
    x = torch.from_numpy(_rand((16, C), 7)).to(torch.bfloat16).requires_grad_()
    scale = torch.tensor(_rand((C,), 8, 0.3, 1.0), requires_grad=True)
    bias = torch.tensor(_rand((C,), 9, 0.1), requires_grad=True)
    y = layernorm.layer_norm(x, scale, bias)
    assert y.dtype == torch.bfloat16
    want = layernorm.ln_reference(x.detach().float(), scale.detach(), bias.detach())
    torch.testing.assert_close(y.float(), want, rtol=2e-2, atol=2e-2)  # one bf16 rounding
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert scale.grad.dtype == bias.grad.dtype == torch.float32
