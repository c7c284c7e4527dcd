"""PyTorch port, data, checkpoints and reporting: the image ops, on-device
augmentation, the augmented training step, the file source and its
decoders, the split, the loader, ``CheckpointStore``, the CSV and banner,
state dict files and ``get_config``.

Against the JAX package on the CPU with the same numpy inputs (every JAX
call jitted): the image ops within 1e-5 in float32 (and against
``cv2.resize``, 1e-4 on 0-255 data); ``augment_from_params`` fed JAX's draws
against JAX's ``augment_batch`` within 1e-5 (on [0, 1] data), nearest class-id
masks equal; one augmented training step
of the tiny model in float32 at drops 0, its draws JAX's, against JAX's
step's loss (1e-5 relative) and first gradients (5e-5 x max|g| per leaf,
``GRAD_TOL``'s ``merge3`` exception), binary and 4-class; the split, the
decoded bytes and the loader's batches equal; the CSV byte for byte; a
``.pth`` from JAX's ``export_cswin_variables`` through the port's forward
within 2e-4 of JAX's.  Against the port itself: the draws' frequencies
(5 sigma) and seeds, checkpoint retention and a resumed augmented ``fit``
bit for bit.
"""

import ast
import dataclasses
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp
import optax

from cswin_simam_unet_tpu import configs as jax_configs
from cswin_simam_unet_tpu.compat.torch_export import export_cswin_variables
from cswin_simam_unet_tpu.data import augment as jax_augment
from cswin_simam_unet_tpu.data import dataset as jax_dataset
from cswin_simam_unet_tpu.data import native_loader as jax_native
from cswin_simam_unet_tpu.data.pipeline import DataLoader as JaxDataLoader
from cswin_simam_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_simam_unet_tpu.ops import image as jax_image
from cswin_simam_unet_tpu.train import engine as jax_engine
from cswin_simam_unet_tpu.train import reporting as jax_reporting

import cswin_simam_unet_tpu_torch
from cswin_simam_unet_tpu_torch import configs
from cswin_simam_unet_tpu_torch.compat import io as port_io
from cswin_simam_unet_tpu_torch.compat import cswin_state_dict, load_flax_params
from cswin_simam_unet_tpu_torch.data import augment, dataset, native_loader
from cswin_simam_unet_tpu_torch.data.pipeline import DataLoader
from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.ops import image
from cswin_simam_unet_tpu_torch.train import engine, reporting
from cswin_simam_unet_tpu_torch.train.checkpoint import CheckpointStore, load_weights, save_weights
from cswin_simam_unet_tpu_torch.train.schedule import make_plateau_scheduler

from test_torch_port_fit import _class_batch, _first_gradients
from test_torch_port_train import GRAD_TOL, TINY, _flax_variables

TOL = 1e-5
CLASSES = 4
LR, WD = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops (the test workers
    share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_err(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got.astype(np.float64) - np.asarray(want, np.float64)).max())


# ---- ops/image.py ----

def test_image_ops_match_jax_and_cv2():
    rs = np.random.RandomState(0)
    img = rs.rand(37, 45, 3).astype(np.float32)
    for oh, ow in ((64, 48), (20, 30), (37, 45)):
        got = image.resize_bilinear(_t(img), oh, ow)
        assert _max_err(got, jax.jit(jax_image.resize_bilinear, static_argnums=(1, 2))(
            img, oh, ow)) <= TOL
        want_cv2 = cv2.resize(img * 255, (ow, oh), interpolation=cv2.INTER_LINEAR)
        assert _max_err(got * 255, want_cv2) <= 1e-4 * 255
    ys = jnp.asarray([0.0, 0.5, 1.5, 2.5, 36.0], jnp.float32)  # halves round to even
    xs = jnp.asarray([0.5, 3.5, 44.0], jnp.float32)
    got = image.sample_nearest(_t(img), _t(ys), _t(xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_image.sample_nearest(img, ys, xs)))
    for method in ("bilinear", "nearest"):
        fn = jax.jit(lambda a, m=method: jax_image.crop_resize(
            a, jnp.asarray(5), jnp.asarray(7), jnp.asarray(25), jnp.asarray(30), 37, 45, m))
        got = image.crop_resize(_t(img), 5, 7, 25, 30, 37, 45, method)
        assert _max_err(got, fn(img)) <= TOL, method
    sq = img[:37, :37]
    for k in range(4):
        np.testing.assert_array_equal(image.rot90_batch_select(_t(sq), k).numpy(),
                                      np.asarray(jax_image.rot90_batch_select(sq, k)))


# ---- data/augment.py ----

def _pair(rs, B=4, N=48):
    images = rs.rand(B, N, N, 3).astype(np.float32)
    masks = (rs.rand(B, N, N, 1) > 0.5).astype(np.float32)
    return images, masks


def _jax_draws(rng, B, cfg):
    return [np.asarray(a) for a in jax.jit(jax_augment._draw_params, static_argnums=(1, 2))(
        rng, B, cfg)]


@pytest.mark.parametrize("nearest", [False, True], ids=["bilinear", "nearest"])
def test_augment_from_params_matches_jax(nearest):
    """JAX's draws through the port's matrix form against JAX's
    ``augment_batch`` and its gather oracle, and the port's gather form;
    class-id masks in the nearest mode (exactly equal), 0/1 masks else."""
    rs = np.random.RandomState(1)
    images, masks = _pair(rs, B=6)
    if nearest:
        masks = rs.randint(0, CLASSES, masks.shape).astype(np.float32)
    cfg = jax_augment.AugmentConfig(mask_nearest=nearest)
    pcfg = augment.AugmentConfig(mask_nearest=nearest)
    ks = set()
    for seed in range(4):
        rng = jax.random.PRNGKey(seed)
        draws = _jax_draws(rng, 6, cfg)
        ks.update(draws[2].tolist())
        want = jax_augment.augment_batch(rng, images, masks, cfg)
        oracle = jax_augment._augment_batch_gather(rng, images, masks, cfg)
        got = augment.augment_from_params(_t(images), _t(masks), *map(_t, draws), cfg=pcfg)
        gather = augment.augment_gather(_t(images), _t(masks), *map(_t, draws), cfg=pcfg)
        mask_tol = 0 if nearest else TOL
        for out, ref in ((got, want), (got, oracle), (gather, oracle)):
            assert _max_err(out[0], ref[0]) <= TOL, seed
            assert _max_err(out[1], ref[1]) <= mask_tol, seed
    assert len(ks) > 1  # a rotation was drawn


def test_forced_transforms_match_the_gather_form():
    """Every k with every flip, forced, at full and at cropped scale: the
    matrix form against the gather form (JAX's and the port's)."""
    rs = np.random.RandomState(2)
    images, masks = _pair(rs, B=1, N=24)
    cfg = jax_augment.AugmentConfig()
    gather = jax.jit(jax.vmap(jax_augment._augment_one, in_axes=(0,) * 8 + (None,)),
                     static_argnums=8)
    for k in range(4):
        for hf, vf in ((False, False), (True, False), (False, True), (True, True)):
            for scale, top, left in ((1.0, 0.0, 0.0), (0.8, 0.3, 0.9)):
                draws = [np.array([hf]), np.array([vf]), np.array([k], np.int32),
                         np.array([scale], np.float32), np.array([top], np.float32),
                         np.array([left], np.float32)]
                want = gather(images, masks, *draws, cfg)
                got = augment.augment_from_params(_t(images), _t(masks), *map(_t, draws))
                for g, w in zip(got, want):
                    assert _max_err(g, w) <= TOL, (k, hf, vf, scale)
    with pytest.raises(ValueError, match="square"):
        augment.augment_from_params(torch.zeros(1, 8, 6, 3), torch.zeros(1, 8, 6, 1),
                                    *map(_t, draws))


def test_draw_params_statistics_and_seeds():
    """65,536 draws: each flip within 5 sigma of 0.5, each non-zero k of
    3/16, k = 0 of 1 - 9/16 ... (13/16), the scale's mean and range of
    U(0.75, 1), the crops' positions of U(0, 1); the same seed gives the
    same draws, another seed others."""
    n = 65536
    draws = augment.draw_params(torch.Generator().manual_seed(3), n)
    hflip, vflip, k, scale, top_u, left_u = draws
    sigma = np.sqrt(0.25 / n)
    for flips in (hflip, vflip):
        assert abs(float(flips.float().mean()) - 0.5) <= 5 * sigma
    for kk in range(4):
        p = 1 - 0.25 * 0.75 if kk == 0 else 0.25 * 0.25
        assert abs(float((k == kk).float().mean()) - p) <= 5 * np.sqrt(p * (1 - p) / n), kk
    assert 0.75 <= float(scale.min()) and float(scale.max()) < 1.0
    assert abs(float(scale.mean()) - 0.875) <= 5 * 0.25 / np.sqrt(12 * n)
    for u in (top_u, left_u):
        assert abs(float(u.mean()) - 0.5) <= 5 / np.sqrt(12 * n)
    again = augment.draw_params(torch.Generator().manual_seed(3), n)
    other = augment.draw_params(torch.Generator().manual_seed(4), n)
    assert all(torch.equal(a, b) for a, b in zip(draws, again))
    assert not torch.equal(scale, other[3])


# ---- the augmented training step against JAX's ----

def _jax_first_step(jm, variables, images, masks, n_classes, cfg, rng):
    tx = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        _first_gradients(), optax.adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                                        weight_decay=WD)))(learning_rate=LR)
    state = jax_engine.TrainState.create(apply_fn=jm.apply, params=variables["params"], tx=tx)
    step = jax_engine.make_train_step(jm, n_classes, augment=cfg, donate=False)
    state, m = step(state, images, masks, rng)
    return float(m["loss"]), state.opt_state.inner_state[0][1]


@pytest.mark.parametrize("n_classes", [1, CLASSES], ids=["binary", "4-class"])
def test_augmented_step_matches_jax(n_classes, monkeypatch):
    """prepare -> augment at image resolution -> finalise -> unshuffle (the
    binary head's flat targets): the port's draws replaced by JAX's from
    ``jax.random.split(rng)[0]``, the loss and the first gradients against
    JAX's ``make_train_step(augment=...)``."""
    multi = n_classes > 1
    # SimAM in the binary model only: the 4-class case is about class-id
    # targets, and without SimAM JAX's step compiles in 14 s instead of 17
    jm = JaxCSWinUNet(**TINY, num_classes=n_classes, use_simam=not multi)
    rs = np.random.RandomState(5)
    variables = _flax_variables(jm, rs)
    images, masks = _class_batch(rs, 2)
    if not multi:
        masks = ((masks > 0) * 255).astype(np.uint8)
    cfg = jax_augment.AugmentConfig(mask_nearest=multi)
    rng = jax.random.PRNGKey(11)
    draws = _jax_draws(jax.random.split(rng)[0], 2, cfg)
    assert draws[2].any() or draws[0].any() or draws[1].any()  # a flip or turn acts
    want_loss, want_g = _jax_first_step(jm, variables, images, masks, n_classes, cfg, rng)

    seen = []

    def jax_draws(generator, B, _cfg):
        seen.append(B)
        return tuple(map(_t, draws))

    monkeypatch.setattr(augment, "draw_params", jax_draws)
    port = CSWinUNet(**TINY, num_classes=n_classes, use_simam=not multi, device="cpu")
    load_flax_params(port, variables)
    opt = engine.make_optimizer("adamw", LR, WD, port.parameters())
    m = engine.make_train_step(port, opt, n_classes,
                               augment=augment.AugmentConfig(mask_nearest=multi))(
        images, masks, rng=7)
    assert seen == [2]
    assert abs(float(m["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    want = cswin_state_dict({"params": want_g}, TINY["depth"])
    named = dict(port.named_parameters())
    for name, g in want.items():
        g = np.asarray(g)
        err = float(np.abs(named[name].grad.numpy() - g).max())
        tol = GRAD_TOL.get(name, 5e-5) * max(float(np.abs(g).max()), 1e-12)
        assert err <= tol, (name, err, tol)


def test_augment_stream_leaves_dropout_seeds_alone(monkeypatch):
    """The augmentation's draws come from their own stream of each
    micro-batch's seed: the forward's dropout seed is the same with and
    without augmentation (``rng``, or ``mix_seed(rng, i)`` under
    ``grad_accum``), and micro-batch i draws from
    ``augment_seed(mix_seed(rng, i))``, as JAX folds i into its
    augmentation key."""
    model = CSWinUNet(**TINY, use_simam=True, device="cpu", seed=6, drop_rate=0.3)
    forward_seeds, draw_seeds = [], []
    forward = model.forward
    model.forward = lambda x, **kw: (forward_seeds.append(kw["rng"]), forward(x, **kw))[1]
    draw = augment.draw_params
    monkeypatch.setattr(augment, "draw_params", lambda gen, B, cfg: (
        draw_seeds.append(gen.initial_seed()), draw(gen, B, cfg))[1])
    opt = engine.make_optimizer("adamw", 0.0, 0.0, model.parameters())
    images, masks = _class_batch(np.random.RandomState(6), 4)
    masks = ((masks > 0) * 255).astype(np.uint8)
    for accum in (1, 2):
        for aug in (None, augment.AugmentConfig()):
            engine.make_train_step(model, opt, augment=aug, grad_accum=accum)(
                images, masks, rng=11)
    micro = [engine.mix_seed(11, i) for i in range(2)]
    assert forward_seeds == [11, 11] + micro + micro
    assert draw_seeds == [engine.augment_seed(11)] + [engine.augment_seed(s) for s in micro]
    assert len(set(draw_seeds) | set(forward_seeds)) == 6


def test_unaugmented_targets_are_the_uint8_unshuffle():
    """Without augmentation the binary head's targets, scaled before the
    unshuffle, are bit for bit the uint8 masks unshuffled and then scaled
    (a permutation commutes with an elementwise map), so the one order of
    preparation leaves every unaugmented trajectory as it was."""
    from cswin_simam_unet_tpu_torch.ops.windows import pixel_unshuffle
    model = CSWinUNet(**TINY, device="cpu")
    rs = np.random.RandomState(9)
    images = rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    masks = rs.randint(0, 256, (2, 64, 64, 1)).astype(np.uint8)
    got_images, got = engine._inputs(model, images, masks, 1)
    want = pixel_unshuffle(torch.from_numpy(masks), engine.FLAT_HEAD_FACTOR).float() / 255.0
    assert torch.equal(got, want)
    assert torch.equal(got_images, torch.from_numpy(images).float() / 255.0)


def test_class_ids_refuse_bilinear_augmentation():
    """Bilinear resampling blends class ids into wrong ones: a multi-class
    step with ``mask_nearest=False`` is refused, and so is ``fit``'s
    default ``AugmentConfig()`` for several classes."""
    model = CSWinUNet(**TINY, num_classes=CLASSES, device="cpu")
    opt = engine.make_optimizer("adamw", LR, WD, model.parameters())
    with pytest.raises(ValueError, match="mask_nearest"):
        engine.make_train_step(model, opt, CLASSES, augment=augment.AugmentConfig())
    images, masks = _class_batch(np.random.RandomState(8), 2)
    with pytest.raises(ValueError, match="mask_nearest"):
        engine.fit(model, opt, [(images, masks)], [],
                   engine.FitConfig(num_epochs=1, n_classes=CLASSES, verbose=False))
    engine.make_train_step(model, opt, CLASSES,
                           augment=augment.AugmentConfig(mask_nearest=True))
    engine.make_train_step(model, opt, 1, augment=augment.AugmentConfig())


# ---- files: the source, the decoders, the split, the loader ----

@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    """Eight image/mask JPEG pairs (48x40, cv2), one without a mask and one
    whose mask holds PNG bytes under its .jpg name."""
    root = tmp_path_factory.mktemp("jpegs")
    rs = np.random.RandomState(7)
    (root / "images").mkdir()
    (root / "masks").mkdir()
    yy, xx = np.mgrid[:40, :48]
    for i in range(8):
        img = (rs.rand(40, 48, 3) * 200).astype(np.uint8)
        mask = (((yy - 20) ** 2 + (xx - 10 - 3 * i) ** 2) < 90).astype(np.uint8) * (
            CLASSES - 1 if i % 2 else 255)
        cv2.imwrite(str(root / "images" / f"s{i}.jpg"), img)
        if i == 3:
            continue  # no mask
        ext = ".png" if i == 5 else ".jpg"  # PNG bytes under a .jpg name
        ok, buf = cv2.imencode(ext, mask)
        (root / "masks" / f"s{i}.jpg").write_bytes(buf.tobytes())
    return str(root / "images"), str(root / "masks")


def _force(monkeypatch, backend):
    """One decoder first, in the port and in JAX: native is JAX's own order
    (cv2 after it), cv2 and PIL alone."""
    if backend == "native":
        return
    monkeypatch.setattr(dataset, "BACKENDS", (backend,))
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)
    if backend == "pil":
        def no_cv2(*a, **k):
            raise ImportError("cv2 hidden")
        monkeypatch.setattr(jax_dataset, "_decode_resize_cv2", no_cv2)


@pytest.mark.parametrize("nearest", [False, True], ids=["bilinear", "nearest"])
@pytest.mark.parametrize("backend", ["native", "cv2", "pil"])
def test_source_matches_jax(jpeg_dir, monkeypatch, backend, nearest):
    """Each decoder forced in turn: every sample byte for byte equal to JAX's
    source; the missing mask and the PNG bytes under a .jpg name (cv2 and
    PIL read them; libjpeg does not, so the native path falls back)."""
    if backend == "native":
        assert native_loader.available(), native_loader.STATUS
    _force(monkeypatch, backend)
    ours = dataset.SegmentationDataSource(*jpeg_dir, (32, 36), mask_nearest=nearest)
    theirs = jax_dataset.SegmentationDataSource(*jpeg_dir, (32, 36), mask_nearest=nearest)
    assert ours.image_paths == theirs.image_paths and len(ours) == 8
    dataset.DECODES.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(len(ours)):
            for a, b in zip(ours.load(i), theirs.load(i)):
                assert a.dtype == np.uint8 and a.shape == b.shape
                np.testing.assert_array_equal(a, b, err_msg=f"{backend} sample {i}")
        assert ours.load(3)[1].max() == 0  # the missing mask
    assert any("no mask found for s3.jpg" in str(w.message) for w in caught)
    if backend != "native":
        assert set(dataset.DECODES) == {backend}
    elif nearest:  # nearest masks skip the bilinear-only library
        assert dataset.DECODES["native"] == 9 and dataset.DECODES["cv2"] == 7
    else:  # cv2 only for the PNG bytes, which libjpeg does not read
        assert dataset.DECODES["native"] == 15 and dataset.DECODES["cv2"] == 1


def test_native_batch_path_matches_jax(jpeg_dir):
    ours = dataset.SegmentationDataSource(*jpeg_dir, (32, 36))
    theirs = jax_dataset.SegmentationDataSource(*jpeg_dir, (32, 36))
    dataset.DECODES.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for idx in ([0, 1, 2], [3, 4], [4, 5, 6]):
            got, want = ours.load_batch(idx), theirs.load_batch(idx)
            assert (got is None) == (want is None) == (5 in idx), idx
            if got is not None:
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
    assert dataset.DECODES["native_batch"] == 6 + 3  # 3 pairs; 2 images, 1 mask


def test_source_refuses_an_empty_directory(tmp_path):
    with pytest.raises(ValueError, match="no images found"):
        dataset.SegmentationDataSource(str(tmp_path), str(tmp_path))


def test_split_matches_jax():
    for n in range(2, 61):
        for split in (0.1, 0.2, 0.25, 0.5):
            for seed in (0, 42):
                if n - int(np.ceil(split * n)) < 1:
                    continue
                got = dataset.train_test_indices(n, split, seed)
                want = jax_dataset.train_test_indices(n, split, seed)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w, err_msg=f"{n} {split} {seed}")


class _Memory:
    """An in-memory source: the loader's interface without files."""

    def __init__(self, n, with_batch=True):
        rs = np.random.RandomState(8)
        self.samples = [(rs.randint(0, 256, (8, 8, 3), dtype=np.uint8),
                         rs.randint(0, 2, (8, 8, 1), dtype=np.uint8) * 255) for _ in range(n)]
        self.batch_loads, self.with_batch = 0, with_batch

    def __len__(self):
        return len(self.samples)

    def load(self, i):
        return self.samples[i]

    def load_batch(self, idx):
        if not self.with_batch:
            return None
        self.batch_loads += 1
        return (np.stack([self.samples[i][0] for i in idx]),
                np.stack([self.samples[i][1] for i in idx]))


@pytest.mark.parametrize("use_native", [True, False], ids=["batch path", "per sample"])
def test_loader_matches_jax(jpeg_dir, use_native):
    """Shuffle on and off, epochs 0-2 (and ``set_epoch`` back to 1),
    ``drop_last``, ``cache_decoded``: the port's batches equal JAX's, over
    the JPEG source (bilinear: the batch path) and an in-memory one."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for src in (dataset.SegmentationDataSource(*jpeg_dir, (16, 16)), _Memory(11)):
            jsrc = (jax_dataset.SegmentationDataSource(*jpeg_dir, (16, 16))
                    if isinstance(src, dataset.SegmentationDataSource) else src)
            idx = np.arange(len(src))[::-1][:7]
            for shuffle, drop, cache in ((True, False, False), (False, True, False),
                                         (True, True, True)):
                kw = dict(batch_size=3, shuffle=shuffle, num_workers=2, seed=5,
                          drop_last=drop, use_native=use_native, cache_decoded=cache)
                ours, theirs = DataLoader(src, idx, **kw), JaxDataLoader(jsrc, idx, **kw)
                assert len(ours) == len(theirs) == (2 if drop else 3)
                for epoch in (0, 1, 2, 1):
                    ours.set_epoch(epoch)
                    theirs.set_epoch(epoch)
                    got, want = list(ours), list(theirs)
                    assert len(got) == len(want) == len(ours)
                    for (gi, gm), (wi, wm) in zip(got, want):
                        assert gi.dtype == np.uint8 and gm.shape[-1] == 1
                        np.testing.assert_array_equal(gi, wi)
                        np.testing.assert_array_equal(gm, wm)
    mem = _Memory(6)
    list(DataLoader(mem, batch_size=2, cache_decoded=True, num_workers=1))
    list(DataLoader(mem, batch_size=2, use_native=False, num_workers=1))
    assert mem.batch_loads == 3


# ---- CheckpointStore, fit's checkpoints and resume ----

def _tiny(seed, **kw):
    return CSWinUNet(**TINY, use_simam=True, device="cpu", seed=seed, **kw)


def _fit(model, cfg, store=None, train=None, test=None, **kw):
    opt = engine.make_optimizer("adamw", LR, WD, model.parameters())
    sched = make_plateau_scheduler(opt, cfg.plateau_factor, cfg.plateau_patience,
                                   cfg.plateau_min_lr)
    cfg = dataclasses.replace(cfg, checkpoint_manager=store)
    return engine.fit(model, opt, train, test, cfg, scheduler=sched, **kw), opt, sched


def test_checkpoint_store_round_trip_and_retention(tmp_path):
    """Save epochs 1-4 with test Dice 0.2, 0.5, 0.4, 0.3 (max_to_keep 2):
    epochs 3 and 4 kept, the best (2) in meta.json and its weights outside
    the retention; restore and restore_weights; reset."""
    model = _tiny(1)
    opt = engine.make_optimizer("adamw", LR, WD, model.parameters())
    sched = make_plateau_scheduler(opt)
    store = CheckpointStore(str(tmp_path / "ck"), max_to_keep=2)
    assert store.latest_epoch() is None and store.best_weights_path() is None
    with pytest.raises(FileNotFoundError):
        store.restore_weights()
    snapshots = {}
    for epoch, dice in ((1, 0.2), (2, 0.5), (3, 0.4), (4, 0.3)):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01 * epoch)
        snapshots[epoch] = {k: v.clone() for k, v in model.state_dict().items()}
        history = {"train_loss": [float(epoch)]}
        store.save_epoch(epoch, model, opt, sched, history, dice, global_step=10 * epoch)
    assert store.all_epochs() == [3, 4] and store.latest_epoch() == 4
    assert store.best_epoch() == (2, 0.5)
    assert not any(name.endswith(".tmp") or ".tmp" in name for name in os.listdir(store.directory))
    fresh = _tiny(9)
    load_weights(store.best_weights_path(), fresh)
    assert all(torch.equal(v, snapshots[2][k]) for k, v in fresh.state_dict().items())
    state, epoch = store.restore_weights(3)
    assert epoch == 3 and all(torch.equal(v, snapshots[3][k]) for k, v in state.items())
    opt2 = engine.make_optimizer("adamw", LR, WD, fresh.parameters())
    sched_state, history, epoch, step = store.restore(fresh, opt2)
    assert (epoch, step, history) == (4, 40, {"train_loss": [4.0]})
    assert sched_state == sched.state_dict()
    assert all(torch.equal(v, snapshots[4][k]) for k, v in fresh.state_dict().items())
    store.reset()
    assert store.latest_epoch() is None and store.best_epoch() == (0, -1.0)
    assert store.best_weights_path() is None


def test_fit_checkpoint_every(tmp_path):
    """checkpoint_every 2 over 3 epochs saves epochs 2 and 3 (the last is
    always saved); 0 saves the last only."""
    rs = np.random.RandomState(9)
    train = [_class_batch(rs, 2)]
    train = [(i, ((m > 0) * 255).astype(np.uint8)) for i, m in train]
    for every, want in ((2, [2, 3]), (0, [3])):
        store = CheckpointStore(str(tmp_path / f"every{every}"))
        cfg = engine.FitConfig(num_epochs=3, verbose=False, checkpoint_every=every, augment=None)
        _fit(_tiny(2), cfg, store, train, train)
        assert store.all_epochs() == want, every


def test_resumed_augmented_fit_is_bitwise_the_unbroken_run(tmp_path):
    """An augmented 2-epoch ``fit`` over a shuffling loader, drops 0.3,
    checkpointed; then a fresh model (other weights) and optimizer restore
    epoch 1 and train epoch 2: every parameter, the optimizer's state and
    the history equal the unbroken run's bit for bit."""
    rs = np.random.RandomState(10)
    images, masks = _class_batch(rs, 6)
    src = _Memory(0)
    src.samples = [(images[i], ((masks[i] > 0) * 255).astype(np.uint8)) for i in range(6)]
    loader = DataLoader(src, batch_size=2, shuffle=True, seed=3, num_workers=1)
    test = DataLoader(src, [0, 1], batch_size=2, num_workers=1)
    cfg = engine.FitConfig(num_epochs=2, verbose=False, seed=5)
    drops = dict(drop_rate=0.3, attn_drop_rate=0.3, drop_path_rate=0.3)
    store = CheckpointStore(str(tmp_path / "ck"))
    model = _tiny(3, **drops)
    (history, step), opt, _ = _fit(model, cfg, store, loader, test)
    assert step == 6 and store.all_epochs() == [1, 2]

    resumed = _tiny(4, **drops)
    opt2 = engine.make_optimizer("adamw", LR, WD, resumed.parameters())
    sched2 = make_plateau_scheduler(opt2, cfg.plateau_factor, cfg.plateau_patience,
                                    cfg.plateau_min_lr)
    sched_state, hist2, epoch, step2 = store.restore(resumed, opt2, epoch=1)
    sched2.load_state_dict(sched_state)
    assert (epoch, step2) == (1, 3)
    hist2, step2 = engine.fit(resumed, opt2, loader, test, cfg, history=hist2,
                              scheduler=sched2, start_epoch=epoch, global_step=step2)
    assert step2 == step and hist2 == history
    for a, b in zip(model.parameters(), resumed.parameters()):
        assert torch.equal(a, b)
    for sa, sb in zip(opt.state.values(), opt2.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq"))


def test_weights_files(tmp_path):
    model = _tiny(5)
    path = str(tmp_path / "w.pth")
    save_weights(path, model)
    other = _tiny(6)
    load_weights(path, other)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), other.parameters()))


# ---- reporting ----

def test_csv_and_banner_match_jax(tmp_path):
    rs = np.random.RandomState(11)
    history = {k: list(rs.rand(3) * 10 ** rs.uniform(-9, 1, 3)) for k in engine.empty_history()}
    reporting.save_metrics_to_csv(history, str(tmp_path / "a.csv"))
    jax_reporting.save_metrics_to_csv(history, str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()
    assert (tmp_path / "a.csv").read_text().splitlines()[0].count(",") == 7
    cfg = {"config": "x", "epochs": 3, "augment": augment.AugmentConfig()}
    assert reporting.config_banner(cfg) == jax_reporting.config_banner(cfg)


def test_fit_logs_to_tensorboard(tmp_path, monkeypatch):
    """``FitConfig.tensorboard_dir``: an event file per run where
    tensorboardX is installed; nothing, and no error, where it is not."""
    pytest.importorskip("tensorboardX")
    rs = np.random.RandomState(12)
    images, masks = _class_batch(rs, 2)
    train = [(images, ((masks > 0) * 255).astype(np.uint8))]
    cfg = engine.FitConfig(num_epochs=1, verbose=False, augment=None,
                           tensorboard_dir=str(tmp_path / "tb"))
    _fit(_tiny(7), cfg, None, train, train)
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "tb"))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import fails
    logger = reporting.TensorBoardLogger(str(tmp_path / "none"))
    logger.log_epoch(1, {"loss": 1.0}, {"loss": 2.0}, 1e-3)
    logger.close()
    assert logger.writer is None and not (tmp_path / "none").exists()


# ---- state dict files from JAX's export ----

@pytest.fixture(scope="module")
def exported():
    jm = JaxCSWinUNet(**TINY, use_simam=True)
    variables = _flax_variables(jm, np.random.RandomState(12))
    x = np.random.RandomState(13).rand(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    return export_cswin_variables(jax.device_get(variables), depth=TINY["depth"]), x, want


@pytest.mark.parametrize("kind", ["pth", "wrapped", "npz"])
def test_jax_export_loads_strictly(exported, tmp_path, kind):
    sd, x, want = exported
    path = str(tmp_path / f"w.{'npz' if kind == 'npz' else 'pth'}")
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v).copy()) for k, v in sd.items()}
    if kind == "npz":
        np.savez(path, **sd)
    else:
        torch.save({"state_dict": tensors} if kind == "wrapped" else tensors, path)
    port = CSWinUNet(**TINY, use_simam=True, device="cpu", seed=99)
    port_io.load_state_dict_strict(port, port_io.load_state_dict_file(path), source=path)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert _max_err(got, want) <= 2e-4


def test_mismatched_config_fails_clearly(exported, tmp_path):
    sd, _, _ = exported
    path = str(tmp_path / "w.npz")
    np.savez(path, **sd)
    state = port_io.load_state_dict_file(path)
    with pytest.raises(ValueError, match="shape mismatch for output.weight.*--config"):
        port_io.load_state_dict_strict(
            CSWinUNet(**TINY, num_classes=3, use_simam=True, device="cpu"), state)
    deeper = dict(TINY, depth=(1, 2, 1, 1))
    with pytest.raises(ValueError, match="missing .*stage2.1.*--config"):
        port_io.load_state_dict_strict(CSWinUNet(**deeper, use_simam=True, device="cpu"), state)
    with pytest.raises(ValueError, match="export-torch"):
        port_io.load_state_dict_file(str(tmp_path / "w.msgpack"))


# ---- configs ----

@pytest.mark.parametrize("name", ["cswinunet", "cswin_tiny_224", "cswin_simam_224",
                                  "cswin_simam_512_dp", "cswin_simam_1024",
                                  "cswin_simam_2048"])
def test_get_config_matches_jax(name):
    """The model's and the run's fields of each config that JAX has too,
    the compute dtype and data parallelism among them."""
    ours, theirs = configs.get_config(name), jax_configs.get_config(name)
    m, jm = ours.model, theirs.model
    assert (ours.image_size, m.num_classes, m.in_chans) == (theirs.image_size, jm.n_classes,
                                                           jm.in_channels)
    for f in ("embed_dim", "depth", "split_size", "num_heads", "mlp_ratio", "qkv_bias",
              "drop_rate", "attn_drop_rate", "drop_path_rate", "use_simam"):
        assert getattr(m, f) == getattr(jm, f), f
    assert m.dtype == jm.dtype
    for f in ("batch_size", "optimizer", "learning_rate", "weight_decay", "num_epochs",
              "plateau_factor", "plateau_patience", "plateau_min_lr", "test_split", "seed",
              "num_workers", "grad_accum", "data_parallel", "checkpoint_dir", "output_prefix"):
        assert getattr(ours.train, f) == getattr(theirs, f), f
    assert dataclasses.asdict(ours.train.augment) == dataclasses.asdict(theirs.augment)
    over = configs.get_config(name, image_size=64, model_dtype="bfloat16", num_epochs=3)
    assert (over.image_size, over.model.dtype, over.train.num_epochs) == (64, "bfloat16", 3)
    with pytest.raises(KeyError, match="unknown config"):
        configs.get_config("no_such_config")


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX, flax,
    optax, orbax, sklearn or the JAX package."""
    root = os.path.dirname(cswin_simam_unet_tpu_torch.__file__)
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
    files.append(os.path.join(os.path.dirname(root), "chip_smoke.py"))
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "cswin_simam_unet_tpu"}
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
    assert len(files) > 30
