"""PyTorch port, spatial sharding of the CSWin(-SimAM)-UNet
(``parallel/spatial_cswin.py``): the image's height over the ranks of a
``('spatial',)`` mesh, on the CPU over gloo.

JAX's tiny geometry (``tests/test_spatial_cswin.py``): embed 16, depths
(1, 1, 1, 1), splits (1, 2, 2, 2), heads (2, 2, 2, 2), batch 2, 64^2 at 2
ranks and 128^2 at 4.  One spawn of 2 ranks and one of 4 (``run_ranks``,
one torch thread a rank) make every sharded run; the tests read them:

* eval at 2 ranks, SimAM on and off, against the port's one-process
  ``CSWinUNet.forward(use_kernels=False)`` within ``TOL_FWD``, the
  parameters' gradients of sum(o cos o) (each rank's ``.grad`` summed over
  the ranks) within ``TOL_GRAD`` x max(1, max|g|); the 4-class head;
  ``capture_stages`` against the one-process model's tokens after each
  stage; 4 ranks at 128^2;
* train mode at drops 0.3: the N-rank forward and gradients against the
  1-rank run of the same function (N = 2 and 4) with JAX's tolerances, and
  the 1-rank run against ``CSWinUNet.forward(train=True)``, which draws the
  same masks; train differs from eval and two seeds differ;
* ``window_keep_mask`` at a window offset against the slice of the whole
  image's mask; the validation messages; once, eval against JAX's
  ``CSWinUNet.apply`` from the same weights.
"""

import numpy as np
import pytest
import torch

from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.ops import dropout
from cswin_simam_unet_tpu_torch.parallel import (gather_rows, make_mesh, run_ranks, shard_rows,
                                                 spatial_cswin_apply, validate_spatial_cswin)

TINY = dict(embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2), num_heads=(2, 2, 2, 2))
DROPS = dict(drop_rate=0.3, attn_drop_rate=0.3, drop_path_rate=0.3)
TOL_FWD = 2e-4    # atol and rtol, tests/test_spatial_cswin.py:46 and :155
TOL_GRAD = 5e-4   # x max(1, max|g|) (and rtol in train mode), tests/test_spatial_cswin.py:172
TOL_MODEL = 1e-5  # the 1-rank train forward against the model's: the same ops
SEED = 7
STAGES = ["embed", *(f"stage{s}" for s in range(1, 5)), *(f"merge{s}" for s in range(1, 4)),
          *(f"upsample{s}" for s in range(1, 5)), *(f"stage_up{s}" for s in range(1, 5))]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(img: int, use_simam: bool = True, num_classes: int = 1, state=None, **extra):
    model = CSWinUNet(img_size=img, **TINY, use_simam=use_simam, num_classes=num_classes,
                      device="cpu", **extra)
    if state is not None:
        model.load_state_dict(state)
    return model


def _images(img: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(0).rand(2, img, img, 3).astype(np.float32))


def _loss(o: torch.Tensor) -> torch.Tensor:
    return (o * torch.cos(o)).sum()


def _run(model, img: int, mesh, **kw) -> dict:
    """The logits (gathered) and the parameters' gradients of sum(o cos o)
    (summed over the ranks) of ``spatial_cswin_apply``, or of one process's
    ``model.forward(use_kernels=False)`` where ``mesh`` is None."""
    x = _images(img)
    if mesh is None:
        o = model(x, use_kernels=False, train=kw.get("train", False), rng=kw.get("seed"))
    else:
        o = spatial_cswin_apply(model, shard_rows(x, mesh), mesh, **kw)
    _loss(o).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    if mesh is not None:
        for g in grads.values():
            mesh.all_reduce_(g)
        o = gather_rows(o, mesh)
    return {"out": o.detach(), "grads": grads}


def _train_runs(img: int, mesh) -> dict:
    return _run(_model(img, **DROPS), img, mesh, train=True, seed=SEED)


def _ranks2(rank: int, jax_state: dict) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh((2,), ("spatial",), device="cpu")
    out = {f"eval_{s}": _run(_model(64, s), 64, mesh) for s in (False, True)}
    out["train"] = _train_runs(64, mesh)
    x = shard_rows(_images(64), mesh)
    with torch.no_grad():
        _, caps = spatial_cswin_apply(_model(64), x, mesh, capture_stages=True)
        out["stages"] = {k: gather_rows(v, mesh) for k, v in caps.items()}
        out["4class"] = gather_rows(spatial_cswin_apply(_model(64, num_classes=4), x, mesh),
                                    mesh)
        model = _model(64, **DROPS)
        out["seeds"] = [gather_rows(spatial_cswin_apply(model, x, mesh, **kw), mesh) for kw in (
            dict(train=True, seed=1), dict(train=True, seed=2), dict(train=True, seed=1), {})]
        out["jax"] = gather_rows(spatial_cswin_apply(_model(64, state=jax_state), x, mesh),
                                 mesh)
    return out


def _ranks4(rank: int) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh((4,), ("spatial",), device="cpu")
    with torch.no_grad():
        logits = spatial_cswin_apply(_model(128), shard_rows(_images(128), mesh), mesh)
    return {"eval": gather_rows(logits, mesh), "train": _train_runs(128, mesh)}


@pytest.fixture(scope="module")
def jax_cswin():
    """JAX's CSWin-UNet at the tiny geometry: its variables as the port's
    state dict, and its eval logits (``model.apply``)."""
    import jax
    from cswin_simam_unet_tpu.models import CSWinUNet as JaxCSWinUNet
    from cswin_simam_unet_tpu_torch.compat import load_flax_params

    jm = JaxCSWinUNet(img_size=64, **TINY, use_simam=True)
    x = _images(64).numpy()
    variables = jax.jit(lambda r: jm.init(r, x, train=False))(jax.random.PRNGKey(0))
    port = _model(64)
    load_flax_params(port, variables)
    want = np.array(jax.jit(lambda v: jm.apply(v, x, train=False))(variables))
    return port.state_dict(), want


@pytest.fixture(scope="module")
def ranks2(jax_cswin, tmp_path_factory):
    return run_ranks(_ranks2, 2, (jax_cswin[0],), device="cpu",
                     store_dir=str(tmp_path_factory.mktemp("store2")))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return run_ranks(_ranks4, 4, device="cpu", store_dir=str(tmp_path_factory.mktemp("store4")))


def _close(got, want, tol: float, what) -> None:
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=tol, err_msg=str(what))


def _check_grads(got: dict, want: dict, rtol: float = 0.0) -> None:
    for name, w in want.items():
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=TOL_GRAD * scale,
                                   rtol=rtol, err_msg=name)


@pytest.mark.parametrize("use_simam", [True, False], ids=["simam", "plain"])
def test_eval_matches_one_process(ranks2, use_simam):
    """2 ranks against the one-process model in eval mode: the logits and
    the parameters' gradients."""
    want = _run(_model(64, use_simam), 64, None)
    for got in ranks2:
        got = got[f"eval_{use_simam}"]
        _close(got["out"], want["out"], TOL_FWD, "logits")
        _check_grads(got["grads"], want["grads"])


def test_capture_stages_and_four_class_head(ranks2):
    """``capture_stages``: each stage's token slabs, gathered, against the
    one-process model's tokens after that stage (forward hooks); and the
    4-class head's logits."""
    model = _model(64)
    seen = {}
    modules = {"embed": model.stage1_conv_embed[2]}
    for s in range(1, 5):
        modules[f"stage{s}"] = getattr(model, f"stage{s}")[-1]
        modules[f"stage_up{s}"] = getattr(model, f"stage_up{s}")[-1]
        modules[f"upsample{s}"] = getattr(model, f"upsample{s}")
        if s < 4:
            modules[f"merge{s}"] = getattr(model, f"merge{s}")
    for name, module in modules.items():
        module.register_forward_hook(lambda m, a, y, name=name: seen.__setitem__(name, y))
    model(_images(64), use_kernels=False)
    assert sorted(seen) == sorted(STAGES)
    four = _model(64, num_classes=4)(_images(64), use_kernels=False)
    for got in ranks2:
        assert sorted(got["stages"]) == sorted(STAGES)
        for name in STAGES:
            _close(got["stages"][name], seen[name].detach(), TOL_FWD, name)
        assert got["4class"].shape == (2, 64, 64, 4)
        _close(got["4class"], four.detach(), TOL_FWD, "4 classes")


def test_four_ranks_eval(ranks4):
    """4 ranks at 128^2 (stage slabs of 8, 4, 2 and 1 rows) against the
    one-process model."""
    want = _model(128)(_images(128), use_kernels=False).detach()
    for got in ranks4:
        _close(got["eval"], want, TOL_FWD, "logits")


def test_train_n_ranks_equal_one_rank(ranks2, ranks4):
    """Train mode at drops 0.3 (dropout, attention dropout, drop-path): 2
    ranks at 64^2 and 4 at 128^2 draw the masks the 1-rank run of the same
    function draws, so the logits and gradients agree; and the 1-rank run
    drops what ``CSWinUNet.forward(train=True)`` drops."""
    one = make_mesh((1,), ("spatial",), device="cpu")
    for img, ranks in ((64, ranks2), (128, ranks4)):
        want = _train_runs(img, one)
        for got in ranks:
            _close(got["train"]["out"], want["out"], TOL_FWD, (img, "logits"))
            _check_grads(got["train"]["grads"], want["grads"], rtol=TOL_GRAD)
    model_run = _run(_model(64, **DROPS), 64, None, train=True, seed=SEED)
    one_run = _train_runs(64, one)
    gap = float((one_run["out"] - model_run["out"]).abs().max())
    assert gap <= TOL_MODEL * max(1.0, float(model_run["out"].abs().max())), gap


def test_train_differs_from_eval_and_by_seed(ranks2):
    """The train path drops (its logits differ from eval's), two seeds drop
    differently, and one seed twice gives the same logits bit for bit."""
    for got in ranks2:
        tr1, tr2, tr1_again, ev = got["seeds"]
        assert not torch.allclose(tr1, ev, atol=1e-3)
        assert not torch.allclose(tr1, tr2, atol=1e-3)
        assert torch.equal(tr1, tr1_again)


def test_window_keep_mask_at_an_offset():
    """The mask of windows [win0, win0 + nwin) of each image of nwin_global
    is that slice of the whole image's mask, for each shard of 2 and 4; the
    defaults (and an offset of 0 among the windows' own count) are the mask
    of windows 0 .. n - 1, bit for bit."""
    B, heads, n, thr = 2, 3, 12, dropout.u32_threshold(0.3)
    nwin_global = 8
    whole = dropout.window_keep_mask(11, B * nwin_global, heads, n, thr)
    whole = whole.reshape(B, nwin_global, heads, n, n)
    for shards in (2, 4):
        nwin = nwin_global // shards
        for r in range(shards):
            got = dropout.window_keep_mask(11, B * nwin, heads, n, thr, nwin=nwin,
                                           win0=r * nwin, nwin_global=nwin_global)
            assert torch.equal(got.reshape(B, nwin, heads, n, n),
                               whole[:, r * nwin:(r + 1) * nwin]), (shards, r)
    ar = torch.arange
    old = dropout.hash_keep_mask(11, ar(6)[:, None, None, None], ar(heads)[None, :, None, None],
                                 ar(n)[None, None, :, None], ar(n)[None, None, None, :], thr, n)
    assert torch.equal(dropout.window_keep_mask(11, 6, heads, n, thr), old)
    assert torch.equal(dropout.window_keep_mask(11, 6, heads, n, thr, nwin=3, win0=0,
                                                nwin_global=3), old)
    assert dropout.kernel_drop_args(0.3, 11) == (11, thr, 1.0 / 0.7, 0, 0, 0)


def test_validate_spatial_cswin_messages():
    """JAX's messages, and the refusals of a train run without a seed and
    of a slab of the wrong height."""
    validate_spatial_cswin(512, 2, (1, 2, 8, 8))
    with pytest.raises(ValueError, match="not divisible by n_shards"):
        validate_spatial_cswin(224, 8, (1, 2, 7, 7))  # stage-2 reso 28 / 8
    with pytest.raises(ValueError, match="stripe height"):
        validate_spatial_cswin(224, 7, (1, 2, 7, 7))  # stage-3 slab 2 rows, stripe 7
    model, one = _model(64, **DROPS), make_mesh((1,), ("spatial",), device="cpu")
    with pytest.raises(ValueError, match="requires seed"):
        spatial_cswin_apply(model, _images(64), one, train=True)
    with pytest.raises(ValueError, match="slab must be 64 x 64"):
        spatial_cswin_apply(model, _images(64)[:, :32], one)


def test_eval_matches_jax(jax_cswin, ranks2):
    """The port's 2-rank eval forward against JAX's ``CSWinUNet.apply`` on
    the whole images, the same weights."""
    for got in ranks2:
        _close(got["jax"], torch.from_numpy(jax_cswin[1]), TOL_FWD, "logits")
