"""PyTorch port, the segmented training step against the port's own
monolithic step (``engine.make_train_step``) on the CPU, float32.

From the same weights and the same step seed the two draw the same
dropout, attention-dropout and drop-path masks (the segmented step puts
the forward's generator back before each recompute), so they compute the
same step: the loss, Dice, IoU and every parameter's gradient within
1e-6 relative (each gradient against its own max|g|), under the residual
policies True, False, a mixed set and "auto" under a tiny budget, at drops
0.3 and 0, ``depth_split`` 0 and 2, with ``grad_accum=2`` and with
augmentation.  Two gloo ranks (``parallel.run_ranks``) of the segmented
step, and of ``fit`` with ``FitConfig(segmented=True)``, against one
process at drops 0, float32 rounding apart.
"""

import gc

import numpy as np
import pytest
import torch

from cswin_simam_unet_tpu_torch.data.augment import AugmentConfig
from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.parallel import make_mesh, run_ranks
from cswin_simam_unet_tpu_torch.train import engine
from cswin_simam_unet_tpu_torch.train.segmented import make_segmented_train_step

GEOM = dict(img_size=64, embed_dim=16, depth=(1, 2, 3, 1), split_size=(1, 2, 2, 2),
            num_heads=(2, 2, 4, 8))
DROPS = dict(drop_rate=0.3, attn_drop_rate=0.3, drop_path_rate=0.3)
RNG = 20261019
TOL = 1e-6               # relative: each gradient x its own max|g|, the loss, Dice, IoU
TOL_RANKS = 2e-4         # the same across 2 ranks (an all-reduce of float32 sums)
WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops: the test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n: int = 2, seed: int = 0):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:64, :64]
    masks = np.stack([(yy - rs.randint(16, 48)) ** 2 + (xx - rs.randint(16, 48)) ** 2 < 200
                      for _ in range(n)])
    return images, (masks[..., None] * 255).astype(np.uint8)


def _model(drops: bool):
    return CSWinUNet(**GEOM, use_simam=True, device="cpu", seed=5, **(DROPS if drops else {}))


def _run(model, make, images, masks, **kw):
    """One step from ``model``'s weights (AdamW at lr 0 keeps them): its
    metrics and gradients."""
    opt = engine.make_optimizer("adamw", 0.0, 0.0, model.parameters())
    metrics = make(model, opt, **kw)(images, masks, rng=RNG)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def _assert_same(got, want, tol=TOL):
    (m, g), (wm, wg) = got, want
    for k in wm:
        assert abs(m[k] - wm[k]) <= tol * max(abs(wm[k]), 1e-30), (k, m, wm)
    assert sorted(g) == sorted(wg)
    for name, ref in wg.items():
        gap = float((g[name] - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        assert gap <= tol, (name, gap)


_MONOLITHIC = {}


def _live_tensors() -> int:
    gc.collect()
    return sum(isinstance(o, torch.Tensor) for o in gc.get_objects())


def _monolithic(drops: bool, **kw):
    key = (drops, tuple(sorted(kw)))
    if key not in _MONOLITHIC:
        _MONOLITHIC[key] = _run(_model(drops), engine.make_train_step, *_batch(), **kw)
    return _MONOLITHIC[key]


@pytest.mark.parametrize("policy", ["save", "recompute", "mixed", "auto"])
def test_policies_match_monolithic(policy):
    """Drops 0.3, depth_split 2 (stage 3 in chunks enc3x0/enc3x1)."""
    save = {"save": True, "recompute": False, "mixed": {"enc1", "enc3x1", "dec3x0", "head"},
            "auto": "auto"}[policy]
    kw = dict(save_residuals=save, depth_split=2)
    if policy == "auto":  # a budget that keeps some segments' residuals and not others'
        kw["residual_budget_bytes"] = 600_000
    model = _model(True)
    opt = engine.make_optimizer("adamw", 0.0, 0.0, model.parameters())
    step = make_segmented_train_step(model, opt, **kw)
    assert (step.residual_policy() is None) == (policy == "auto")
    metrics = step(*_batch(), rng=RNG)
    got = ({k: float(v) for k, v in metrics.items()},
           {n: p.grad.detach().clone() for n, p in model.named_parameters()})
    _assert_same(got, _monolithic(True))
    if policy == "auto":  # sizing leaves nothing behind: another build's first call
        live = _live_tensors()
        make_segmented_train_step(model, opt, **kw)(*_batch(), rng=RNG)
        assert _live_tensors() == live
    modes = step.residual_policy()
    assert list(modes)[3:5] == ["enc3x0", "enc3x1"] and len(modes) == 11
    if policy in ("mixed", "auto"):
        assert len(set(modes.values())) == 2, modes
    if policy == "mixed":
        assert {n for n, s in modes.items() if s} == save


@pytest.mark.parametrize("case", ["drops 0, unsplit", "grad_accum 2", "augment"])
def test_variants_match_monolithic(case):
    drops = case != "drops 0, unsplit"
    kw = {"drops 0, unsplit": {}, "grad_accum 2": dict(grad_accum=2),
          "augment": dict(augment=AugmentConfig())}[case]
    want = _monolithic(drops, **kw)
    seg_kw = dict(save_residuals={"enc2", "bottleneck"} if drops else False,
                  depth_split=2 if drops else 0)
    _assert_same(_run(_model(drops), make_segmented_train_step, *_batch(), **kw, **seg_kw),
                 want)


def _ranks(rank: int) -> dict:
    """Each rank: the segmented step of the global batch of 2 under a data
    mesh (a mixed policy, which holds under the mesh), and ``fit`` with
    ``segmented=True`` for one epoch of two batches."""
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    images, masks = _batch()
    model = _model(False)
    opt = engine.make_optimizer("adamw", 0.0, 0.0, model.parameters())
    step = make_segmented_train_step(model, opt, mesh=mesh, save_residuals={"enc2"},
                                     depth_split=2)
    metrics = {k: float(v) for k, v in step(images, masks, rng=RNG).items()}
    out = dict(step=(metrics, {n: p.grad.detach().clone() for n, p in model.named_parameters()}),
               policy=step.residual_policy())
    out["fit"] = _fit(mesh)
    return out


def _fit(mesh=None):
    model = _model(False)
    opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
    cfg = engine.FitConfig(num_epochs=1, augment=None, segmented=True, seg_depth_split=2,
                           verbose=False)
    history, _ = engine.fit(model, opt, [_batch(2, 1), _batch(2, 2)], [_batch(2, 3)], cfg,
                            mesh=mesh)
    return history


def test_two_ranks_match_one_process(tmp_path):
    ranks = run_ranks(_ranks, WORLD, device="cpu", store_dir=str(tmp_path))
    want = _run(_model(False), make_segmented_train_step, *_batch(), save_residuals=False)
    fit_want = _fit()
    for r in ranks:
        assert r["policy"]["enc2"] and not r["policy"]["enc1"]
        _assert_same(r["step"], want, TOL_RANKS)
        for k, series in fit_want.items():
            np.testing.assert_allclose(r["fit"][k], series, rtol=TOL_RANKS, err_msg=k)
