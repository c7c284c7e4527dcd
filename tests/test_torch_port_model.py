"""PyTorch port, model: a tiny CSWinUNet's flax variables, converted by the
port's ``compat/weights.py`` and loaded strictly into the port, against the
JAX model on the CPU in float32.

The port runs with ``use_kernels=True`` (on the CPU the kernel wrappers take
their plain versions) and with ``use_kernels=False``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cswin_simam_unet_tpu.compat import export_cswin_variables
from cswin_simam_unet_tpu.models import CSWinUNet as JaxCSWinUNet

from cswin_simam_unet_tpu_torch.compat import cswin_state_dict, load_flax_params
from cswin_simam_unet_tpu_torch.configs import build_model
from cswin_simam_unet_tpu_torch.models import CSWinUNet

TINY = dict(img_size=64, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2),
            num_heads=(2, 2, 4, 8))
TOL = 2e-4


@pytest.fixture(scope="module")
def flax_variables():
    """Flax CSWinUNet variables: the tree and shapes that flax's init
    declares (traced, not compiled), the values drawn from a numpy seed —
    non-zero biases and norm parameters included, which flax's own init
    leaves at 0 and 1.  One tree serves both configs: SimAM adds no
    parameters."""
    shapes = jax.eval_shape(JaxCSWinUNet(**TINY).init, jax.random.PRNGKey(1),
                            jnp.zeros((1, 64, 64, 3)))
    rs = np.random.RandomState(7)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        noise = rs.randn(*leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * noise
        if "bias" in name:
            return 0.05 * noise
        return noise / np.sqrt(np.prod(leaf.shape[:-1]))  # kernels: 1/sqrt(fan-in)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=[True, False], ids=["simam", "plain"])
def pair(request, flax_variables):
    """(flax variables, port model, input batch, JAX logits) for one config."""
    jm = JaxCSWinUNet(**TINY, use_simam=request.param)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    variables = flax_variables
    port = CSWinUNet(**TINY, use_simam=request.param, device="cpu", seed=5)
    load_flax_params(port, variables)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    return variables, port, x, want


def test_weights_match_torch_export(pair):
    variables, port, _, _ = pair
    got = cswin_state_dict(variables, TINY["depth"])
    want = export_cswin_variables(variables, TINY["depth"])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert set(port.state_dict()) == set(want)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_logits_and_predict_match_jax(pair, use_kernels):
    _, port, x, want = pair
    with torch.inference_mode():
        got = port(torch.from_numpy(x), use_kernels=use_kernels)
        probs = port.predict(torch.from_numpy(x), use_kernels=use_kernels)
    assert got.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    want_p = np.asarray(jax.nn.sigmoid(want))
    np.testing.assert_allclose(probs.numpy(), want_p, rtol=TOL, atol=TOL)


def test_geometry_and_heads_are_validated():
    with pytest.raises(ValueError, match="split_size"):
        CSWinUNet(**{**TINY, "split_size": (3, 2, 2, 2)}, device="cpu")
    with pytest.raises(ValueError, match="even"):
        CSWinUNet(**{**TINY, "num_heads": (3, 2, 4, 8)}, device="cpu")


def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CSWinUNet(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("cswin_simam_512")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("cswin_simam_512", device="cuda")
