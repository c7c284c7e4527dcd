"""PyTorch port, the segmented training step against the JAX package, its
refusals and its configs.

Against JAX on the CPU in float32 (the JAX side traced with
``jax.eval_shape`` or jitted): the segment names and the parameter
partition of ``build_segments`` / ``segment_param_keys`` at ``depth_split``
0 and 2, JAX's root keys mapped to the port's state_dict names through the
port's ``compat.cswin_state_dict``; one step of JAX's
``make_segmented_train_step`` (drops 0, ``save_residuals=False``) against
the port's, both with SGD at a learning rate of 1 so that the updated
parameters are the parameters less the gradients: the loss and every
updated parameter within 2e-4 x max(1, max|ref|), the model tolerance;
``get_config``'s ``segmented``, ``seg_depth_split`` and
``cswin_simam_2048_dp``.  Against the port: what it refuses, and that two
builds keep their own segments.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cswin_simam_unet_tpu import configs as jax_configs
from cswin_simam_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_simam_unet_tpu.train import engine as jax_engine
from cswin_simam_unet_tpu.train import segmented as jax_segmented

from cswin_simam_unet_tpu_torch import configs
from cswin_simam_unet_tpu_torch.compat import cswin_state_dict, load_flax_params
from cswin_simam_unet_tpu_torch.models import CSWinUNet, UNet
from cswin_simam_unet_tpu_torch.train import engine
from cswin_simam_unet_tpu_torch.train.segmented import (build_segments,
                                                        make_segmented_train_step,
                                                        segment_param_keys)

import test_torch_port_data
from test_torch_port_train import _disc_batch, _flax_variables

# stage 3 of 3 blocks: chunked at depth_split 2, stage 2 (2 blocks) not
GEOM = dict(img_size=64, embed_dim=16, depth=(1, 2, 3, 1), split_size=(1, 2, 2, 2),
            num_heads=(2, 2, 4, 8))
TOL_MODEL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops: the test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("depth_split", [0, 2])
def test_segments_match_jax(depth_split):
    jm = JaxCSWinUNet(**GEOM, use_simam=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    jsegs = jax_segmented.build_segments(jm, flat_logits=True, depth_split=depth_split)
    jpart = jax_segmented.segment_param_keys(shapes, jsegs)
    # every leaf of JAX root key i holds i, so each converted tensor names its root key
    roots = sorted(shapes)
    marked = {k: jax.tree.map(lambda a, i=i: np.full(a.shape, i, np.float32), shapes[k])
              for i, k in enumerate(roots)}
    owner = {name: roots[int(v.flat[0])]
             for name, v in cswin_state_dict({"params": marked}, GEOM["depth"]).items()}

    model = CSWinUNet(**GEOM, use_simam=True, device="cpu")
    segs = build_segments(model, True, depth_split)
    assert [s.name for s in segs] == [name for name, _ in jsegs]
    assert sorted(owner) == sorted(n for n, _ in model.named_parameters())
    want = [sorted(n for n, root in owner.items() if root in keys) for keys in jpart]
    assert segment_param_keys(model, segs) == want
    assert any("x" in s.name for s in segs) == bool(depth_split)


def test_segmented_step_matches_jax():
    """One step of each segmented step, SGD at lr 1 (updated = p - g)."""
    rs = np.random.RandomState(3)
    jm = JaxCSWinUNet(**GEOM, use_simam=True)
    variables = _flax_variables(jm, rs)
    images, masks = _disc_batch(rs)
    state = jax_engine.TrainState.create(apply_fn=jm.apply, params=variables["params"],
                                         tx=optax.sgd(1.0))
    jstep = jax_segmented.make_segmented_train_step(jm, save_residuals=False,
                                                    donate_carries=False, donate_state=False)
    new_state, jmetrics = jstep(state, jnp.asarray(images), jnp.asarray(masks),
                                jax.random.PRNGKey(0))
    want = cswin_state_dict({"params": jax.device_get(new_state.params)}, GEOM["depth"])

    model = CSWinUNet(**GEOM, use_simam=True, device="cpu")
    load_flax_params(model, variables)
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    metrics = make_segmented_train_step(model, opt, save_residuals=False)(images, masks, rng=0)
    loss = float(jmetrics["loss"])
    assert abs(float(metrics["loss"]) - loss) <= TOL_MODEL * max(1.0, abs(loss))
    worst = 0.0
    for name, p in model.state_dict().items():
        ref = want[name]
        gap = float(np.abs(p.numpy() - ref).max()) / max(1.0, float(np.abs(ref).max()))
        assert gap <= TOL_MODEL, (name, gap)
        worst = max(worst, gap)
    print(f"largest updated-parameter gap {worst:.3e} x max(1, max|ref|)")


@pytest.mark.parametrize("case", ["negative depth_split", "unknown segment", "unet"])
def test_segmented_refusals(case):
    model = CSWinUNet(**GEOM, use_simam=True, device="cpu")
    kw, match = {}, ""
    if case == "negative depth_split":
        kw, match = dict(depth_split=-1), "depth_split must be >= 0"
    elif case == "unknown segment":
        kw, match = dict(save_residuals={"enc2", "enc9"}), r"names not segments: \['enc9'\]"
    else:
        model, match = UNet(n_classes=1, device="cpu"), "supports the CSWin family only"
    opt = engine.make_optimizer("adamw", 1e-3, 0.0, model.parameters())
    with pytest.raises(ValueError, match=match):
        make_segmented_train_step(model, opt, **kw)


def test_two_builds_keep_their_own_segments():
    """Segments and ownership live in each build, not in a registry: a
    build at depth_split 2 keeps its chunks after one at 0, and each
    step's policy names its own segments."""
    model = CSWinUNet(**GEOM, use_simam=True, device="cpu")
    opt = engine.make_optimizer("adamw", 0.0, 0.0, model.parameters())
    split = make_segmented_train_step(model, opt, save_residuals=True, depth_split=2)
    whole = make_segmented_train_step(model, opt, save_residuals=True)
    images, masks = _disc_batch(np.random.RandomState(4))
    for step in (split, whole):
        step(images, masks, rng=1)
    assert "enc3x1" in split.residual_policy() and "enc3" not in split.residual_policy()
    assert "enc3" in whole.residual_policy() and "enc3x1" not in whole.residual_policy()
    segs2, segs0 = build_segments(model, True, 2), build_segments(model, True, 0)
    assert [s.name for s in segs2] == list(split.residual_policy())
    assert [s.name for s in segs0] == list(whole.residual_policy())
    for segs in (segs2, segs0):
        assert sorted(k for keys in segment_param_keys(model, segs) for k in keys) == sorted(
            n for n, _ in model.named_parameters())


def test_configs_match_jax():
    """``segmented`` and ``seg_depth_split`` of every config that both
    packages have, and all of ``cswin_simam_2048_dp``."""
    common = sorted(set(configs.CONFIGS) & set(jax_configs.CONFIGS))
    assert "cswin_simam_2048_dp" in common
    for name in common:
        ours, theirs = configs.get_config(name).train, jax_configs.get_config(name)
        assert (ours.segmented, ours.seg_depth_split) == (theirs.segmented,
                                                          theirs.seg_depth_split), name
    test_torch_port_data.test_get_config_matches_jax("cswin_simam_2048_dp")
    run = configs.get_config("cswin_simam_2048_dp").train
    assert (run.batch_size, run.data_parallel, run.segmented, run.seg_depth_split) == (
        8, True, True, 3)
