"""PyTorch port, the UNet family in training: the step, gradient
accumulation, the eval step, ``fit`` with a resume, and the CLI.

Against the JAX package on the CPU with the same numpy inputs and weights
(every JAX call jitted), at JAX's test width (``base_features=4``) on 32^2
images, L2-coupled Adam at the UNet configs' lr 1e-3 and weight decay
1e-4, no augmentation.  In float32, the configs' dtype, with the port put
back on JAX's parameters, running statistics and Adam moments before each
of three steps: the loss within 1e-5 x max(1, |JAX|), Dice and IoU within
a few pixels (``TOL_COUNTED``), the
running statistics within 2e-4 x max(1, max|JAX|) (moved once a
micro-batch with ``grad_accum=2``, at an equal batch of 4 and a ragged one
of 3), the parameters within two Adam steps and each tensor's update
within 0.25 of JAX's in relative norm (see ``F32``).  In float64 on
both sides, three unbroken steps of the binary SimAM model and of the
4-class one over a ragged accumulated batch: metrics, every gradient,
running statistics and parameters within 1e-9.  The eval step on running
statistics: the loss within 2e-4, Dice and IoU a few pixels.  Against
the port itself: a resumed ``fit``
(augmented, checkpointed) bit for bit, BatchNorm buffers included, and the
CLI end to end with its default config (``unet``, full width at
``--image-size 32``).
"""

import contextlib
import csv
import importlib
import io
import os
import re

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp
import optax

from cswin_simam_unet_tpu.models import UNet as JaxUNet
from cswin_simam_unet_tpu.train import engine as jax_engine

from cswin_simam_unet_tpu_torch import cli, configs
from cswin_simam_unet_tpu_torch.compat import load_flax_params, unet_state_dict
from cswin_simam_unet_tpu_torch.compat.io import load_state_dict_file, load_state_dict_strict
from cswin_simam_unet_tpu_torch.models import UNet
from cswin_simam_unet_tpu_torch.train import engine
from cswin_simam_unet_tpu_torch.train.checkpoint import CheckpointStore
from cswin_simam_unet_tpu_torch.train.schedule import make_plateau_scheduler

from test_torch_port_train import _WideFloat
from test_torch_port_unet import BASE, IMG, TOL_MODEL, _close, jax_unet_variables, port_unet

LR, WD = 1e-3, 1e-4  # the UNet configs' Adam
STEPS = 3
TOL_METRIC = 1e-5    # loss per step, x max(1, |JAX|)
# Dice and IoU per step in float32: they count thresholded pixels, and a
# logit within rounding of 0 now and then lands on the other side (one pixel
# of 2 x 32^2 moves Dice by about 5e-4); a few pixels
TOL_COUNTED = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops (the test workers
    share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(rs, n, n_classes):
    """uint8 images and masks that depend on them: 0/255 for one class,
    class ids 0..3 for four."""
    images = (rs.rand(n, IMG, IMG, 3) * 255).astype(np.uint8)
    if n_classes == 1:
        return images, ((images[..., :1] > 128) * 255).astype(np.uint8)
    return images, (images[..., :1] // 64).astype(np.uint8)


def _last_gradients():
    """A pass-through optax transformation whose state keeps the gradients
    it was last given: in front of Adam it records the gradients of JAX's
    own training step."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        return updates, updates

    return optax.GradientTransformation(init, update)


def _jax_state(jm, variables):
    """JAX's ``make_optimizer("adam")`` with the recorder in front of it."""
    tx = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        _last_gradients(), optax.add_decayed_weights(WD),
        optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8), optax.scale(-learning_rate)))(
        learning_rate=LR)
    return jax_engine.TrainState.create(apply_fn=jm.apply, params=variables["params"], tx=tx,
                                        batch_stats=variables["batch_stats"])


def _as_port(state, tree):
    """A flax tree shaped like the params (the params, a gradient, an Adam
    moment) under the port's names, the running statistics beside it."""
    return unet_state_dict({"params": tree, "batch_stats": state.batch_stats})


def _sync(port, opt, state):
    """Put JAX's parameters, running statistics and Adam moments into the
    port, so that each step starts from one state in both."""
    load_flax_params(port, {"params": state.params, "batch_stats": state.batch_stats})
    adam = state.opt_state.inner_state[2]
    mu, nu = _as_port(state, adam.mu), _as_port(state, adam.nu)
    for name, p in port.named_parameters():
        st = opt.state[p]
        st["step"].fill_(float(adam.count))
        st["exp_avg"].copy_(torch.from_numpy(np.array(mu[name])))
        st["exp_avg_sq"].copy_(torch.from_numpy(np.array(nu[name])))


# float32, the configs' dtype: the port is put back on JAX's state before
# each step.  Its gradients are held in float64 (below): in float32 a ReLU
# input within rounding of 0 now and then takes the other side in one
# framework (as it does between float32 and float64 in either) and moves
# the gradients upstream of it by a few % of their max, and Adam's step,
# about lr x sign(g + wd p) at first, goes either way where the loss
# gradient cancels the decay term to within rounding.  So in float32 each
# parameter is held within two Adam steps (2 lr) of JAX's, and each tensor's
# step (new - old) within 0.25 of JAX's step in relative norm: of 4 cases
# x 3 steps x 64 tensors the largest reading was 0.081 (``up2.up.bias``,
# ragged accumulation); a skipped step reads 1, one the wrong way 2.  Left
# out of the step's check: the conv biases before a BatchNorm, whose loss
# gradient is rounding noise (the batch mean takes them out), so that their
# Adam step's direction is that of the noise plus wd p.
_NOISE_BIASES = ("double_conv.0.bias", "double_conv.3.bias")
F32 = dict(sync=True, loss=TOL_METRIC, counted=TOL_COUNTED, stats=TOL_MODEL, param=2 * LR,
           update=0.25, grad=None)
F64 = dict(sync=False, loss=1e-10, counted=1e-10, stats=1e-10, param=1e-9, update=None,
           grad=1e-9)


def _steps_match_jax(n_classes, use_simam, batch, grad_accum, seed, tol=F32):
    """``STEPS`` steps of JAX's ``make_train_step`` and of the port's: every
    step's metrics, running statistics and parameters, and in float64 its
    gradients."""
    wide = tol is F64
    rs = np.random.RandomState(seed)
    jm = JaxUNet(n_classes=n_classes, base_features=BASE, use_simam=use_simam,
                 dtype=jnp.float64 if wide else jnp.float32)
    variables = jax_unet_variables(jm, rs)
    images, masks = _batch(rs, batch, n_classes)
    port = port_unet(variables, n_classes, use_simam)
    if wide:
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        port.double()
        port.dtype = torch.float64
    state = _jax_state(jm, variables)
    jstep = jax_engine.make_train_step(jm, n_classes, augment=None, donate=False,
                                       grad_accum=grad_accum)
    opt = engine.make_optimizer("adam", LR, WD, port.parameters())
    step = engine.make_train_step(port, opt, n_classes, augment=None, grad_accum=grad_accum)
    for i in range(STEPS):
        if i and tol["sync"]:
            _sync(port, opt, state)
        before = _as_port(state, state.params)
        state, want = jstep(state, images, masks, jax.random.PRNGKey(i))
        got = step(images, masks)
        for key in ("loss", "dice", "iou"):
            _close(got[key], want[key], tol["loss" if key == "loss" else "counted"],
                   f"step {i} {key}")
        grads = _as_port(state, state.opt_state.inner_state[0])
        for name, p in port.named_parameters() if tol["grad"] else ():
            g, want_g = p.grad.numpy(), grads[name]
            if name.endswith(_NOISE_BIASES):
                # a conv bias before BatchNorm: the batch mean takes it out,
                # so its gradient is rounding noise in both
                scale = float(np.abs(grads[name[:-4] + "weight"]).max())
                assert max(np.abs(g).max(), np.abs(want_g).max()) <= tol["grad"] * scale, name
                continue
            err = float(np.abs(g - want_g).max())
            assert err <= tol["grad"] * max(float(np.abs(want_g).max()), 1e-30), (i, name, err)
        want_sd = _as_port(state, state.params)
        own = port.state_dict()
        for name, b in port.named_buffers():
            if not name.endswith("num_batches_tracked"):
                _close(b, want_sd[name], tol["stats"], f"step {i} {name}")
            else:  # once a micro-batch
                assert int(b) == min(grad_accum, batch) * (1 if tol["sync"] else i + 1), name
        for name, _ in port.named_parameters():
            gap = float(np.abs(own[name].numpy() - want_sd[name]).max())
            assert gap <= tol["param"], (i, name, gap)
            if tol["update"] and not name.endswith(_NOISE_BIASES):
                want_step = want_sd[name].astype(np.float64) - before[name]
                got_step = own[name].numpy().astype(np.float64) - before[name]
                rel = np.linalg.norm(got_step - want_step) / np.linalg.norm(want_step)
                assert rel <= tol["update"], (i, name, rel)


@pytest.mark.parametrize("n_classes,use_simam", [(1, True), (4, False)],
                         ids=["binary-simam", "4-classes"])
def test_train_steps_match_jax(n_classes, use_simam):
    """Three Adam steps of the step ``fit`` and the CLI use, batch 2."""
    _steps_match_jax(n_classes, use_simam, 2, 1, seed=20 + n_classes)


@pytest.mark.parametrize("batch", [4, 3], ids=["equal", "ragged"])
def test_grad_accum_matches_jax(batch):
    """``grad_accum=2``: JAX's ``lax.scan`` over equal micro-batches and its
    unrolled loop over ragged ones (2 + 1 of 3); the running statistics move
    once a micro-batch, the second from the first's."""
    _steps_match_jax(1, batch == 3, batch, 2, seed=30 + batch)


def test_steps_match_jax_in_float64(monkeypatch):
    """The step's arithmetic, nothing rounded to float32: JAX under
    ``jax.enable_x64`` with float64 variables and compute dtype, its
    modules' ``jnp.float32`` (the batch's scaling, SimAM's statistics, the
    loss, the metrics) widened to float64, and the port in float64 with
    ``Tensor.float`` widened likewise.  Three steps each of the binary SimAM
    model (batch 2) and the 4-class one with ``grad_accum=2`` over a ragged
    batch of 3: metrics, gradients, running statistics and parameters within
    1e-9 (x max|g| for the gradients)."""
    for name in ("ops.simam", "train.losses", "train.engine", "train.metrics"):
        module = importlib.import_module(f"cswin_simam_unet_tpu.{name}")
        monkeypatch.setattr(module, "jnp", _WideFloat(module.jnp))
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    with jax.enable_x64(True):
        _steps_match_jax(1, True, 2, 1, seed=70, tol=F64)
        _steps_match_jax(4, False, 3, 2, seed=71, tol=F64)


def test_eval_step_matches_jax():
    """The eval step normalises with the running statistics, and leaves
    them as they were."""
    rs = np.random.RandomState(41)
    for n_classes in (1, 4):
        jm = JaxUNet(n_classes=n_classes, base_features=BASE, use_simam=True)
        variables = jax_unet_variables(jm, rs)
        images, masks = _batch(rs, 2, n_classes)
        want = jax_engine.make_eval_step(jm, n_classes)(_jax_state(jm, variables), images, masks)
        port = port_unet(variables, n_classes, use_simam=True)
        before = {k: v.clone() for k, v in port.state_dict().items()}
        got = engine.make_eval_step(port, n_classes)(images, masks)
        for key in ("loss", "dice", "iou"):
            _close(got[key], want[key], TOL_MODEL if key == "loss" else TOL_COUNTED,
                   f"{n_classes} classes {key}")
        for name, v in port.state_dict().items():
            assert torch.equal(v, before[name]), name


def test_step_calls_the_unet_with_train_alone():
    """The step calls both families with the CSWin-UNet's keywords; of
    those the UNet acts on ``train`` alone: ``use_kernels`` and ``rng``
    leave its logits as they are, and it has no flat head, whatever the
    classes, so ``flat_logits=True`` raises and the step never asks for
    it."""
    model = UNet(base_features=BASE, device="cpu")
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(2, IMG, IMG, 3).astype(np.float32))
    for train in (False, True):
        want = model(x, train=train)
        for kw in (dict(use_kernels=False), dict(rng=7), dict(use_kernels=True, rng=None)):
            assert torch.equal(model(x, train=train, **kw), want), (train, kw)
    with pytest.raises(ValueError, match="no flat logits"):
        model(x, flat_logits=True)
    assert not engine._flat_head(model, 1) and not engine._flat_head(model, 4)
    cswin = configs.build_model("cswin_tiny_224", device="cpu", img_size=64)
    assert engine._flat_head(cswin, 1) and not engine._flat_head(cswin, 4)
    images, masks = _batch(rs, 2, 1)
    step = engine.make_train_step(model, engine.make_optimizer("adam", LR, WD,
                                                               model.parameters()), 1)
    metrics = step(images, masks)
    assert np.isfinite(float(metrics["loss"])) and not model.training


def _fit(model, train, test, store, **kw):
    opt = engine.make_optimizer("adam", LR, WD, model.parameters())
    sched = make_plateau_scheduler(opt, 0.5, 0, 1e-7)
    cfg = engine.FitConfig(num_epochs=2, checkpoint_manager=store, plateau_patience=0,
                           verbose=False, **kw)
    return opt, sched, cfg


def test_fit_resumed_follows_the_unbroken_run(tmp_path):
    """A 2-epoch augmented ``fit`` checkpointed every epoch; a fresh model
    and optimizer restore epoch 1 and train epoch 2: parameters, running
    statistics and history bit for bit."""
    rs = np.random.RandomState(50)
    train = [_batch(rs, n, 1) for n in (2, 2, 1)]
    test = [_batch(rs, 2, 1)]
    model = UNet(base_features=BASE, use_simam=True, device="cpu", seed=1)
    store = CheckpointStore(str(tmp_path / "ck"))
    opt, sched, cfg = _fit(model, train, test, store)
    history, step = engine.fit(model, opt, train, test, cfg, scheduler=sched)
    assert store.all_epochs() == [1, 2] and step == 6

    fresh = UNet(base_features=BASE, use_simam=True, device="cpu", seed=2)
    opt2, sched2, _ = _fit(fresh, train, test, store)
    sched_state, hist2, epoch, step2 = store.restore(fresh, opt2, epoch=1)
    assert int(fresh.inc.double_conv[1].num_batches_tracked) == 3
    sched2.load_state_dict(sched_state)
    hist2, step2 = engine.fit(fresh, opt2, train, test, cfg, history=hist2, scheduler=sched2,
                              start_epoch=epoch, global_step=step2)
    assert step2 == step and hist2 == history
    for (name, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), name
    assert int(fresh.inc.double_conv[1].num_batches_tracked) == 6


def _run(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue()


def test_cli_trains_evaluates_predicts_and_exports_the_default_unet(tmp_path):
    """``train`` without ``--config`` (JAX's default, ``unet``, at full
    width) for an epoch at ``--image-size 32`` on the CPU, then
    ``evaluate`` (the history's numbers), ``predict`` and ``export-torch``
    (a ``.pth`` that loads strictly into a fresh UNet)."""
    rs = np.random.RandomState(60)
    for sub in ("images", "masks"):
        (tmp_path / sub).mkdir()
    yy, xx = np.mgrid[:48, :48]
    for i in range(8):
        img = (rs.rand(48, 48, 3) * 120).astype(np.uint8)
        disc = (yy - rs.randint(14, 34)) ** 2 + (xx - rs.randint(14, 34)) ** 2 < 100
        img[disc] = 230
        cv2.imwrite(str(tmp_path / "images" / f"im_{i}.jpg"), img)
        cv2.imwrite(str(tmp_path / "masks" / f"im_{i}.jpg"), disc.astype(np.uint8) * 255)
    dirs = ["--image-dir", str(tmp_path / "images"), "--mask-dir", str(tmp_path / "masks")]
    common = ["--image-size", "32", "--device", "cpu"]
    out = tmp_path / "out"
    log = _run(["train", *common, *dirs, "--output-dir", str(out), "--epochs", "1",
                "--no-progress"])
    assert "config: unet" in log and "params: 31043521" in log and "Epoch [1/1]" in log
    ckpt = out / "unet_checkpoints"
    with open(out / "unet_training_metrics.csv", newline="") as f:
        row = list(csv.DictReader(f))[-1]

    log = _run(["evaluate", *common, *dirs, "--weights", str(ckpt / "best_weights.pth"),
                "--split", "test"])
    m = re.search(r"Loss: (\S+), Dice: (\S+), IoU: (\S+)", log)
    for got, key in zip(map(float, m.groups()), ("Test_Loss", "Test_Dice", "Test_IoU")):
        assert abs(got - float(row[key])) <= 1e-6, (key, got, row)

    log = _run(["predict", *common, "--image-dir", dirs[1], "--weights", str(ckpt),
                "--output-dir", str(tmp_path / "pred")])
    assert "Wrote 8 masks" in log and len(os.listdir(tmp_path / "pred")) == 8

    pth = str(tmp_path / "unet.pth")
    log = _run(["export-torch", "--image-size", "32", "--weights", str(ckpt), "--output", pth])
    assert "(136 tensors)" in log
    fresh = configs.build_model("unet", device="cpu", seed=3)
    load_state_dict_strict(fresh, load_state_dict_file(pth), source=pth)
    final = load_state_dict_file(str(out / "unet_final_weights.pth"))
    for name, v in fresh.state_dict().items():
        assert torch.equal(v, final[name]), name
    assert "unet: unet img=448 bs=4 opt=adam simam=False classes=1" in _run(["list-configs"])
