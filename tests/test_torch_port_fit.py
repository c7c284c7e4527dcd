"""PyTorch port, the rest of training: the multi-class loss and metrics,
L2-coupled Adam, the plateau schedule, the multi-class step, gradient
accumulation, the eval step, ``evaluate``, ``device_prefetch`` and ``fit``.

Against the JAX package on the CPU in float32 with the same numpy inputs
(every JAX call jitted): the losses and metrics within 1e-6 x max(1, |ref|),
Adam within 1e-6, the schedule's learning rate within 1e-7 relative, the
4-class step's first gradients against those of JAX's step (its
``jax.value_and_grad``) within 5e-5 x max|g| per leaf (``GRAD_TOL``'s
``merge3`` exception), the binary eval step within 1e-4, and one 2-epoch
``fit`` of the tiny 4-class model: its 7 history series within 1e-4, its
learning rates within 1e-6 relative (JAX keeps the rate in float32).
Against the port itself: gradient accumulation against the full batch,
dropout seeds per step and per micro-batch, and a resumed ``fit``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cswin_simam_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_simam_unet_tpu.train import engine as jax_engine
from cswin_simam_unet_tpu.train import losses as jax_losses
from cswin_simam_unet_tpu.train import metrics as jax_metrics
from cswin_simam_unet_tpu.train.schedule import ReduceLROnPlateau as JaxPlateau

from cswin_simam_unet_tpu_torch.compat import cswin_state_dict, load_flax_params
from cswin_simam_unet_tpu_torch.data import device_prefetch
from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.parallel import Mesh, make_mesh
from cswin_simam_unet_tpu_torch.train import engine, losses, metrics
from cswin_simam_unet_tpu_torch.train.schedule import make_plateau_scheduler

from test_torch_port_train import GRAD_TOL, TINY, _flax_variables

LR, WD = 1e-3, 1e-4
CLASSES = 4
DROPS = dict(drop_rate=0.3, attn_drop_rate=0.3, drop_path_rate=0.3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops: the test workers
    share the machine's cores, and torch's default of a thread a core in
    each worker makes those ops wait on one another (20x slower here)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, name=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def _class_batch(rs, n, img=64):
    """uint8 images and class-id masks: discs of classes 1-3 on background 0,
    each disc brighter in the image."""
    images = rs.randint(0, 160, (n, img, img, 3)).astype(np.uint8)
    masks = np.zeros((n, img, img, 1), np.uint8)
    yy, xx = np.mgrid[:img, :img]
    for i in range(n):
        for c in range(1, CLASSES):
            cy, cx = rs.randint(12, img - 12, size=2)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < rs.randint(36, 120)
            masks[i, disc, 0] = c
            images[i][disc] = 160 + 30 * c
    return images, masks


def _binary_batch(rs, n, img=64):
    images, masks = _class_batch(rs, n, img)
    return images, ((masks > 0) * 255).astype(np.uint8)


# ---- losses and metrics against JAX's functions ----

def test_losses_match_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(2, 8, 8, CLASSES).astype(np.float32) * 3
    labels = rs.randint(0, CLASSES, (2, 8, 8))
    got = losses.softmax_cross_entropy(_t(logits), _t(labels))
    _close(got, jax.jit(jax_losses.softmax_cross_entropy)(logits, labels), 1e-6, "ce")
    _close(losses.segmentation_loss(_t(logits), _t(labels), CLASSES),
           jax.jit(jax_losses.segmentation_loss, static_argnums=2)(logits, labels, CLASSES),
           1e-6, "segmentation ce")
    flat = rs.randn(2, 8, 8, 16).astype(np.float32) * 3
    soft = rs.rand(2, 8, 8, 16).astype(np.float32)
    _close(losses.soft_dice_loss(_t(flat), _t(soft)),
           jax.jit(jax_losses.soft_dice_loss)(flat, soft), 1e-6, "soft dice")
    want = jax.jit(jax_losses.segmentation_loss, static_argnums=(2, 3))(flat, soft, 1, 0.5)
    _close(losses.segmentation_loss(_t(flat), _t(soft), 1, dice_weight=0.5), want, 1e-6,
           "bce + dice")
    # the dice term joins the binary loss only, as in JAX
    assert float(losses.segmentation_loss(_t(logits), _t(labels), CLASSES, 0.5)) == float(got)


def test_metrics_match_jax():
    rs = np.random.RandomState(1)
    logits = rs.randn(2, 8, 8, CLASSES).astype(np.float32)
    labels = rs.randint(0, CLASSES, (2, 8, 8))
    onehot = np.eye(CLASSES, dtype=np.float32)[labels]
    want = jax.jit(jax_metrics.multiclass_metrics)(logits, onehot)
    got = metrics.multiclass_metrics(_t(logits), _t(onehot))
    for g, w, name in zip(got, want, ("dice", "iou")):
        _close(g, w, 1e-6, name)
    _close(metrics.multiclass_dice(_t(logits), _t(onehot)),
           jax.jit(jax_metrics.multiclass_dice)(logits, onehot), 1e-6, "multiclass_dice")
    flat = rs.randn(2, 4, 4, 16).astype(np.float32)
    soft = (rs.rand(2, 4, 4, 16) > 0.5).astype(np.float32)
    soft[0, 0, 0] = 0.5
    for n, lg, tg in ((CLASSES, logits, labels), (1, flat, soft)):
        sums = jax.jit(jax_engine._metric_sums, static_argnums=2)(lg, tg, n)
        got_sums = engine._metric_sums(_t(lg), _t(tg), n)
        assert tuple(got_sums.shape) == (3, n)
        _close(got_sums, sums, 1e-6, f"sums {n}")
        for g, w, name in zip(engine._metrics_from_sums(got_sums),
                              jax.jit(jax_engine._metrics_from_sums)(sums), ("dice", "iou")):
            _close(g, w, 1e-6, f"{name} from sums, {n} classes")


def test_finalize_targets_clips_like_jax():
    masks = np.array([0, 1, 2, 3, 4, 255, 7], np.uint8).reshape(1, 1, 7, 1)
    want = jax_engine._finalize_targets(
        jax_engine._prepare_batch(jnp.zeros((1, 1, 7, 3), jnp.uint8), masks, CLASSES)[1], CLASSES)
    got = engine._finalize_targets(engine._prepare_batch(
        torch.zeros(1, 1, 7, 3, dtype=torch.uint8), _t(masks), CLASSES)[1], CLASSES)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.reshape(-1).tolist() == [0, 1, 2, 3, 3, 3, 3]


# ---- optimizer and schedule ----

def test_adam_l2_matches_jax():
    rs = np.random.RandomState(2)
    w0 = rs.randn(5, 3).astype(np.float32)
    grads = [rs.randn(5, 3).astype(np.float32) for _ in range(3)]
    p = torch.nn.Parameter(_t(w0.copy()))
    opt = engine.make_optimizer("adam", LR, 0.1, [p])
    state = jax_engine.TrainState.create(apply_fn=None, params={"w": jnp.asarray(w0)},
                                         tx=jax_engine.make_optimizer("adam", LR, 0.1))
    apply = jax.jit(lambda s, g: s.apply_gradients(grads={"w": g}))
    for i, g in enumerate(grads):
        if i == 2:
            engine.set_learning_rate(opt, LR / 2)
            jax_engine.set_learning_rate(state, LR / 2)
            assert engine.get_learning_rate(opt) == LR / 2
        p.grad = _t(g)
        opt.step()
        state = apply(state, jnp.asarray(g))
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(state.params["w"]),
                                   rtol=0, atol=1e-6)


PLATEAU_LOSSES = [1.0, 0.9, 0.9, 0.9, 0.89995,  # 0.89995 misses 0.9 x (1 - 1e-4)
                  0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8]  # halvings down to min_lr, then held


@pytest.mark.parametrize("cooldown", [0, 1])
def test_plateau_schedule_matches_jax(cooldown):
    kw = dict(factor=0.5, patience=1, min_lr=2e-4, cooldown=cooldown)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = engine.make_optimizer("adamw", LR, WD, [p])
    sched = make_plateau_scheduler(opt, **kw)
    ref = JaxPlateau(lr=LR, **kw)
    lrs = []
    for i, loss in enumerate(PLATEAU_LOSSES):
        if i == 6:  # a state_dict round trip on both sides
            sched_state, ref_state = sched.state_dict(), ref.state_dict()
            sched = make_plateau_scheduler(opt, factor=0.9, patience=7)
            sched.load_state_dict(sched_state)
            ref = JaxPlateau(lr=1.0)
            ref.load_state_dict(ref_state)
        sched.step(loss)
        want = ref.step(loss)
        got = engine.get_learning_rate(opt)
        assert abs(got - want) <= 1e-7 * want, (i, got, want)
        lrs.append(got)
    # 1e-3, 5e-4, 2.5e-4 and the clamp at min_lr (1.25e-4 -> 2e-4); the
    # cooldown delays the clamp by an epoch
    assert sorted(set(lrs)) == pytest.approx([2e-4, 2.5e-4, 5e-4, 1e-3])
    assert lrs.index(min(lrs)) == 9 + cooldown


# ---- the 4-class step and fit against JAX ----

def _loaders(rs):
    """Two training batches of discs and a test batch labelled class 3
    everywhere: training moves the model towards background, so the test
    loss rises in epoch 2 and the schedule (patience 0) halves the rate."""
    train = [_class_batch(rs, 2) for _ in range(2)]
    images, masks = _class_batch(rs, 2)
    return train, [(images, np.full_like(masks, CLASSES - 1))]


def _first_gradients():
    """A pass-through optax transformation whose state keeps the first
    gradients it is given: in front of AdamW it records the gradients that
    JAX's own training step computes (``jax.value_and_grad`` of its loss)."""
    def init(params):
        return jnp.zeros((), jnp.int32), jax.tree.map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        n, first = state
        first = jax.tree.map(lambda a, g: jnp.where(n == 0, g, a), first, updates)
        return updates, (n + 1, first)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_fit():
    """One JAX ``fit`` of the tiny 4-class SimAM model (drops 0, no
    augmentation, 2 epochs, plateau patience 0) from flax variables drawn
    from a numpy seed, with the first step's gradients.  One compile of the
    step serves both (the file must stay under a minute on one worker)."""
    jm = JaxCSWinUNet(**TINY, num_classes=CLASSES, use_simam=True)
    rs = np.random.RandomState(3)
    variables = _flax_variables(jm, rs)
    train, test = _loaders(rs)
    # JAX's make_optimizer("adamw") with the recorder in front of it
    tx = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        _first_gradients(), optax.adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                                        weight_decay=WD)))(learning_rate=LR)
    state = jax_engine.TrainState.create(apply_fn=jm.apply, params=variables["params"], tx=tx)
    cfg = jax_engine.FitConfig(num_epochs=2, n_classes=CLASSES, augment=None,
                               plateau_patience=0, verbose=False)
    state, history = jax_engine.fit(jm, state, train, test, cfg)
    grads = state.opt_state.inner_state[0][1]
    return variables, train, test, grads, history


def _port(variables, **kw):
    port = CSWinUNet(**TINY, num_classes=CLASSES, use_simam=True, device="cpu", **kw)
    load_flax_params(port, variables)
    return port


def test_fit_matches_jax(jax_fit):
    variables, train, test, _, want = jax_fit
    # the schedule is exercised: JAX's run halves the rate after epoch 2
    assert want["learning_rates"][-1] < want["learning_rates"][0]
    port = _port(variables)
    opt = engine.make_optimizer("adamw", LR, WD, port.parameters())
    cfg = engine.FitConfig(num_epochs=2, n_classes=CLASSES, augment=None, plateau_patience=0,
                           verbose=False)
    got, global_step = engine.fit(port, opt, train, test, cfg)
    assert global_step == 4 and set(got) == set(want)
    for key, series in want.items():
        assert len(got[key]) == len(series) == 2, key
        if key == "learning_rates":
            for g, w in zip(got[key], series):
                assert abs(g - w) <= 1e-6 * w, (key, g, w)
        else:
            np.testing.assert_allclose(got[key], series, rtol=0, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_multiclass_step_grads_match_jax(jax_fit, use_kernels):
    """The 4-class step's first gradients against JAX's step's on the same
    batch: image-layout logits (the kernel path pixel-shuffles its flat
    logits), softmax cross-entropy."""
    variables, train, _, grads, _ = jax_fit
    port = _port(variables)
    engine.compute_gradients(port, *train[0], CLASSES, use_kernels)
    want = cswin_state_dict({"params": grads}, TINY["depth"])
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        g = np.asarray(g)
        err = float(np.abs(named[name].grad.numpy() - g).max())
        tol = GRAD_TOL.get(name, 5e-5) * max(float(np.abs(g).max()), 1e-12)
        assert err <= tol, (name, err, tol)


def test_binary_eval_step_matches_jax():
    jm = JaxCSWinUNet(**TINY, use_simam=True)
    rs = np.random.RandomState(4)
    variables = _flax_variables(jm, rs)
    images, masks = _binary_batch(rs, 2)
    state = jax_engine.TrainState.create(apply_fn=jm.apply, params=variables["params"],
                                         tx=jax_engine.make_optimizer("adamw", LR, WD))
    want = jax_engine.make_eval_step(jm, 1)(state, images, masks)
    port = CSWinUNet(**TINY, use_simam=True, device="cpu")
    load_flax_params(port, variables)
    got = engine.make_eval_step(port, 1)(images, masks)
    for k in engine.METRICS:
        assert abs(float(got[k]) - float(want[k])) <= 1e-4, (k, float(got[k]), float(want[k]))


# ---- the port against itself ----

def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("n_classes", [1, CLASSES])
@pytest.mark.parametrize("batch", [4, 3], ids=["equal", "ragged"])
def test_grad_accum_matches_full_batch(n_classes, batch):
    rs = np.random.RandomState(5)
    images, masks = (_class_batch if n_classes > 1 else _binary_batch)(rs, batch)
    results = []
    for accum in (1, 2):
        model = CSWinUNet(**TINY, num_classes=n_classes, use_simam=True, device="cpu", seed=5)
        opt = engine.make_optimizer("adamw", LR, WD, model.parameters())
        m = engine.make_train_step(model, opt, n_classes, grad_accum=accum)(images, masks)
        results.append(({k: float(v) for k, v in m.items()}, _grads(model)))
    (full, g_full), (acc, g_acc) = results
    assert abs(acc["loss"] - full["loss"]) <= 1e-6 * abs(full["loss"])
    for k in ("dice", "iou"):
        assert abs(acc[k] - full[k]) <= 1e-6, (k, acc[k], full[k])
    for name, g in g_full.items():
        err = float((g_acc[name] - g).abs().max())
        assert err <= 1e-5 * max(float(g.abs().max()), 1e-12), (name, err)


def test_micro_batches_are_jax_splits():
    assert engine.micro_batches(4, 2) == [(0, 2, 0.5), (2, 4, 0.5)]
    assert engine.micro_batches(3, 2) == [(0, 1, 1 / 3), (1, 3, 2 / 3)]
    assert engine.micro_batches(2, 4) == [(0, 1, 0.5), (1, 2, 0.5)]


def test_step_seeds_at_drops():
    """Drops 0.3: two steps from the same weights and ``rng`` agree bitwise;
    the two micro-batches of one step drop different elements (the same
    image twice gives two different logits)."""
    rs = np.random.RandomState(6)
    images, masks = _binary_batch(rs, 2)
    runs = []
    for _ in range(2):
        model = CSWinUNet(**TINY, use_simam=True, device="cpu", seed=6, **DROPS)
        opt = engine.make_optimizer("adamw", LR, WD, model.parameters())
        m = engine.make_train_step(model, opt)(images, masks, rng=11)
        runs.append((float(m["loss"]), list(model.parameters())))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))

    model = CSWinUNet(**TINY, use_simam=True, device="cpu", seed=6, **DROPS)
    seen = []
    forward = model.forward

    def spy(x, **kw):
        out = forward(x, **kw)
        seen.append((kw["rng"], out.detach().clone()))
        return out

    model.forward = spy
    opt = engine.make_optimizer("adamw", LR, WD, model.parameters())
    twice = (np.repeat(images[:1], 2, axis=0), np.repeat(masks[:1], 2, axis=0))
    engine.make_train_step(model, opt, grad_accum=2)(*twice, rng=11)
    assert len(seen) == 2 and seen[0][0] != seen[1][0]
    assert not torch.equal(seen[0][1], seen[1][1])


def test_fit_resumes_exactly(capsys):
    """2 epochs in one ``fit`` against 1 epoch and a resumed second, drops
    0.3: the step seeds depend on (seed, epoch, global step) only.  The
    resumed run prints (``verbose``, ``log_every``, the progress line),
    which changes nothing it computes."""
    rs = np.random.RandomState(7)
    train, test = _loaders(rs)
    cfg = engine.FitConfig(num_epochs=2, n_classes=CLASSES, augment=None, plateau_patience=0,
                           verbose=False)
    runs = []
    for split in (False, True):
        model = CSWinUNet(**TINY, num_classes=CLASSES, use_simam=True, device="cpu", seed=7,
                          **DROPS)
        opt = engine.make_optimizer("adamw", LR, WD, model.parameters())
        sched = make_plateau_scheduler(opt, cfg.plateau_factor, cfg.plateau_patience,
                                       cfg.plateau_min_lr)
        if split:
            history, step = engine.fit(model, opt, train, test,
                                       dataclasses.replace(cfg, num_epochs=1), scheduler=sched)
            loud = dataclasses.replace(cfg, verbose=True, log_every=1)
            history, step = engine.fit(model, opt, train, test, loud, history=history,
                                       scheduler=sched, start_epoch=1, global_step=step)
            out, err = capsys.readouterr()
            assert "Epoch [2/2]" in out and "epoch 2 batch 2: loss" in out
            assert "Epoch [1/2]" not in out and "epoch 2/2 batch 1/2: loss" in err
        else:
            history, step = engine.fit(model, opt, train, test, cfg, scheduler=sched)
        runs.append((history, step, [p.detach().clone() for p in model.parameters()]))
    (h_one, s_one, p_one), (h_two, s_two, p_two) = runs
    assert s_one == s_two == 4
    for key, series in h_one.items():
        np.testing.assert_allclose(h_two[key], series, rtol=0, atol=1e-6, err_msg=key)
    assert all(torch.equal(a, b) for a, b in zip(p_one, p_two))


def test_evaluate_empty_loader_gives_nan():
    model = CSWinUNet(**TINY, use_simam=True, device="cpu")
    got = engine.evaluate(engine.make_eval_step(model), [], "cpu")
    assert set(got) == set(engine.METRICS) and all(np.isnan(v) for v in got.values())


def test_device_prefetch_keeps_order():
    rs = np.random.RandomState(8)
    batches = [(rs.randint(0, 256, (2, 3), dtype=np.uint8), torch.full((2,), i))
               for i in range(5)]
    got = list(device_prefetch(iter(batches), "cpu"))
    assert len(got) == len(batches)
    for (a, b), (x, y) in zip(got, batches):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), x)
        assert b is y  # a tensor already on the device passes through
    assert list(device_prefetch([], "cpu")) == []


def test_fit_rejects_what_is_not_ported():
    """A mesh with a tensor-parallel axis, once refused, trains: ``fit`` on
    a (1, 1) ``('data', 'model')`` mesh (the state replicated over both
    axes, as JAX's ``fit`` places it; drops 0.3) gives the history and the
    weights of ``fit`` without a mesh, bit for bit.  A mesh over another
    axis is still refused."""
    rs = np.random.RandomState(12)
    train = [_binary_batch(rs, 2) for _ in range(2)]
    test = [_binary_batch(rs, 2)]
    runs = []
    for mesh in (None, make_mesh((1, 1), ("data", "model"), device="cpu")):
        model = CSWinUNet(**TINY, use_simam=True, device="cpu", **DROPS)
        opt = engine.make_optimizer("adamw", LR, WD, model.parameters())
        cfg = engine.FitConfig(num_epochs=1, augment=None, verbose=False)
        history, step = engine.fit(model, opt, train, test, cfg, mesh=mesh)
        runs.append((history, step, [p.detach().clone() for p in model.parameters()]))
    (h_mesh, n_mesh, p_mesh), (h_one, n_one, p_one) = runs[1], runs[0]
    assert n_mesh == n_one == 2 and h_mesh == h_one
    assert all(torch.equal(a, b) for a, b in zip(p_mesh, p_one))
    with pytest.raises(ValueError, match=r"take a \('data',\) or \('data', 'model'\) mesh"):
        engine.fit(model, opt, [], [], cfg, mesh=Mesh(1, 0, torch.device("cpu"), ("model",)))


@pytest.mark.parametrize("seg_depth_split", [1, -1])
def test_fit_segmented(seg_depth_split):
    """``FitConfig(segmented=True)`` trains with the segmented step, whose
    steps equal the monolithic step's (drops 0.3, one seed a step): the
    same history and weights.  A negative ``seg_depth_split`` is refused."""
    rs = np.random.RandomState(11)
    train = [_binary_batch(rs, 2) for _ in range(2)]
    test = [_binary_batch(rs, 2)]
    runs = []
    for segmented in (True, False):
        model = CSWinUNet(**TINY, use_simam=True, device="cpu", **DROPS)
        opt = engine.make_optimizer("adamw", LR, WD, model.parameters())
        cfg = engine.FitConfig(num_epochs=1, augment=None, segmented=segmented,
                               seg_depth_split=seg_depth_split, verbose=False)
        if seg_depth_split < 0 and segmented:
            with pytest.raises(ValueError, match="depth_split must be >= 0"):
                engine.fit(model, opt, train, test, cfg)
            return
        history, step = engine.fit(model, opt, train, test, cfg)
        runs.append((history, step, [p.detach().clone() for p in model.parameters()]))
    (h_seg, n_seg, p_seg), (h_mono, n_mono, p_mono) = runs
    assert n_seg == n_mono == 2
    for key, series in h_mono.items():
        np.testing.assert_allclose(h_seg[key], series, rtol=1e-6, atol=0, err_msg=key)
    assert all(float((a - b).abs().max()) <= 1e-6 for a, b in zip(p_seg, p_mono))
