"""PyTorch port, spatial sharding (``parallel/spatial.py``): an image's
height over the ranks of a ``('spatial',)`` mesh, on the CPU over gloo.

The ranks are processes (``parallel.run_ranks``: ``spawn``, a ``file://``
store in the test's temporary directory), each at one torch thread; a
spawned rank imports this module by name, so JAX is imported only in the
test process.  One spawn of 2 ranks and one of 4 make every sharded run,
and the tests read their results:

* ``halo_pad`` at 4 ranks against the global zero pad, and its backward
  against the gradient of the global pad;
* the H-sharded UNet (``base_features=4``, 32^2 at 2 ranks, 64^2 at 4)
  against the port's one-process ``UNet.forward``: eval and train mode
  within ``TOL_FWD`` (``tests/test_spatial.py``'s 2e-4), the parameters'
  gradients of sum(o cos o) in train mode (each rank's ``.grad`` summed over
  the ranks) within ``TOL_GRAD`` x max(1, max|g|), SimAM off and on.  The
  gradients are taken in float64 on both sides: in float32 the gradient of
  a conv bias before a BatchNorm, which the batch mean takes out, is
  rounding noise that reached 3.2e-4 at 4 ranks;
* once, the 2-rank UNet against JAX's ``spatial_unet_apply`` on a 2-device
  CPU mesh from the same weights;
* ``spatial_stripe_attention`` for horizontal stripes, vertical stripes and
  the global window against the plain ``stripe_attention`` of the whole
  grid, forward and gradients, and at attention dropout 0.3 the same mask.
"""

import numpy as np
import pytest
import torch

from cswin_simam_unet_tpu_torch.models import CSWinUNet, UNet
from cswin_simam_unet_tpu_torch.ops import attention
from cswin_simam_unet_tpu_torch.parallel import (gather_rows, halo_pad, make_mesh, run_ranks,
                                                 shard_rows, spatial_stripe_attention,
                                                 spatial_unet_apply, validate_spatial_geometry)
from cswin_simam_unet_tpu_torch.parallel.mesh import Mesh
from cswin_simam_unet_tpu_torch.train import engine

TOL_FWD = 2e-4    # atol and rtol, tests/test_spatial.py:73
TOL_GRAD = 3e-4   # x max(1, max|g|), tests/test_spatial.py:99
TOL_ATTN = 1e-5   # float32 attention, the same sums in the same order but the gather
# attention geometries of a 16 x 16 grid (hsp, wsp): vertical, horizontal, global
ATTN_GEOMS = [(16, 2), (2, 16), (16, 16)]
ATTN = dict(B=2, H=16, C=8, heads=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(img: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(0).rand(2, img, img, 3).astype(np.float32))


def _loss(o: torch.Tensor) -> torch.Tensor:
    return (o * torch.cos(o)).sum()


def _unet_runs(model_fn, x: torch.Tensor, mesh) -> dict:
    """Eval and train logits (gathered) and the train-mode parameter
    gradients of sum(o cos o) in float64, summed over the ranks (or of one
    process where ``mesh`` is None)."""
    out = {}
    for mode, dtype in (("eval", torch.float32), ("train", torch.float32),
                        ("grads", torch.float64)):
        model, train = model_fn(dtype), mode != "eval"
        if mesh is None:
            o = model(x, train=train)
        else:
            o = spatial_unet_apply(model, shard_rows(x, mesh), mesh, train=train)
        out[mode] = (o if mesh is None else gather_rows(o, mesh)).detach()
    _loss(o).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    if mesh is not None:
        for g in grads.values():
            mesh.all_reduce_(g)
    out["grads"] = grads
    return out


def _attn_inputs():
    rs = np.random.RandomState(0)
    B, H, C = ATTN["B"], ATTN["H"], ATTN["C"]
    q, k, v = (torch.from_numpy(rs.randn(B, H * H, C).astype(np.float32)) for _ in range(3))
    lepe = torch.from_numpy(rs.randn(3, 3, 1, C).astype(np.float32))
    return q, k, v, lepe


def _attn_runs(mesh) -> dict:
    """Each geometry: the output and the gradients of sum(o cos o) for q, k,
    v (gathered) and the LePE kernel (summed over the ranks); and the output
    at attention dropout 0.3."""
    out = {}
    H = ATTN["H"]
    for hsp, wsp in ATTN_GEOMS:
        q, k, v, lepe = _attn_inputs()
        kw = dict(H=H, W=H, hsp=hsp, wsp=wsp, num_heads=ATTN["heads"])
        if mesh is None:
            leaves = [t.requires_grad_() for t in (q, k, v, lepe)]
            o = attention.stripe_attention(*leaves, **kw)
            drop = attention.stripe_attention(q, k, v, lepe, **kw, attn_drop=0.3, seed=99)
        else:
            leaves = [shard_rows(t, mesh).requires_grad_() for t in (q, k, v)]
            leaves.append(lepe.requires_grad_())
            o = spatial_stripe_attention(*leaves, **kw, mesh=mesh)
            drop = spatial_stripe_attention(*leaves, **kw, mesh=mesh, attn_drop=0.3, seed=99)
        _loss(o).backward()
        if mesh is None:
            grads = [t.grad for t in leaves]
        else:
            grads = [gather_rows(t.grad, mesh) for t in leaves[:3]]
            grads.append(mesh.all_reduce_(leaves[3].grad))
            o, drop = gather_rows(o, mesh), gather_rows(drop, mesh)
        out[(hsp, wsp)] = dict(out=o.detach(), grads=grads, drop=drop.detach())
    return out


def _unet(use_simam: bool, state=None):
    def make(dtype=torch.float32):
        model = UNet(base_features=4, use_simam=use_simam, device="cpu")
        if dtype == torch.float64:
            model.double()
            model.dtype = dtype
        if state is not None:
            model.load_state_dict(state)
        return model
    return make


def _ranks2(rank: int, jax_state: dict) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh((2,), ("spatial",), device="cpu")
    assert mesh.shape == {"spatial": 2}
    x = _images(32)
    out = {f"unet_{s}": _unet_runs(_unet(s), x, mesh) for s in (False, True)}
    model = _unet(False, jax_state)()
    with torch.no_grad():
        out["jax"] = {m: gather_rows(spatial_unet_apply(model, shard_rows(x, mesh), mesh,
                                                        train=m), mesh) for m in (False, True)}
    out["attention"] = _attn_runs(mesh)
    return out


def _ranks4(rank: int) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh((4,), ("spatial",), device="cpu")
    x = torch.arange(2 * 16 * 4 * 3, dtype=torch.float64).reshape(2, 16, 4, 3)
    slab = shard_rows(x, mesh).requires_grad_()
    padded = halo_pad(slab, 1, mesh)
    w = torch.cos(torch.arange(padded.numel(), dtype=torch.float64)).reshape(padded.shape)
    (padded * w).sum().backward()
    return {"halo": (padded.detach(), slab.grad, w),
            "unet": _unet_runs(_unet(True), _images(64), mesh)}


@pytest.fixture(scope="module")
def jax_unet():
    """JAX's UNet at the test width: its variables as the port's state
    dict, and JAX's ``spatial_unet_apply`` on a 2-device mesh, eval and
    train."""
    import jax
    from cswin_simam_unet_tpu.models import UNet as JaxUNet
    from cswin_simam_unet_tpu.parallel import make_mesh as jax_make_mesh
    from cswin_simam_unet_tpu.parallel.spatial import spatial_unet_apply as jax_apply
    from cswin_simam_unet_tpu_torch.compat import load_flax_params

    jm = JaxUNet(base_features=4)
    x = _images(32).numpy()
    variables = jax.jit(lambda r: jm.init(r, x, train=False))(jax.random.PRNGKey(0))
    port = UNet(base_features=4, device="cpu")
    load_flax_params(port, variables)
    mesh = jax_make_mesh((2,), ("spatial",), devices=jax.devices()[:2])
    want = {m: np.asarray(jax.jit(lambda v, m=m: jax_apply(jm, v, x, mesh, train=m))(variables))
            for m in (False, True)}
    return port.state_dict(), want


@pytest.fixture(scope="module")
def ranks2(jax_unet, tmp_path_factory):
    return run_ranks(_ranks2, 2, (jax_unet[0],), device="cpu",
                     store_dir=str(tmp_path_factory.mktemp("store2")))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return run_ranks(_ranks4, 4, device="cpu", store_dir=str(tmp_path_factory.mktemp("store4")))


def _check_unet(got: dict, want: dict) -> None:
    for mode in ("eval", "train"):
        np.testing.assert_allclose(got[mode].numpy(), want[mode].numpy(), atol=TOL_FWD,
                                   rtol=TOL_FWD, err_msg=mode)
    for name, w in want["grads"].items():
        scale = max(1.0, float(w.abs().max()))
        gap = float((got["grads"][name] - w).abs().max())
        assert gap <= TOL_GRAD * scale, (name, gap, scale)


def test_halo_pad_matches_global_zero_pad(ranks4):
    """At 4 ranks each slab's halo'd rows are the rows of the globally zero
    padded image around it, and the gradient of sum(w * halo'd slab) is the
    gradient of the global pad: each received row's gradient lands on the
    sender's edge row."""
    x = torch.arange(2 * 16 * 4 * 3, dtype=torch.float64).reshape(2, 16, 4, 3)
    ref = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    grad = torch.zeros_like(ref)
    for r, got in enumerate(ranks4):
        padded, _, w = got["halo"]
        assert torch.equal(padded, ref[:, 4 * r:4 * r + 6]), r
        grad[:, 4 * r:4 * r + 6] += w
    for r, got in enumerate(ranks4):
        assert torch.equal(got["halo"][1], grad[:, 1 + 4 * r:5 + 4 * r]), r


@pytest.mark.parametrize("use_simam", [False, True], ids=["plain", "simam"])
def test_spatial_unet_matches_one_process(ranks2, use_simam):
    """2 ranks at 32^2 against ``UNet.forward`` on the whole images: eval,
    train (the global batch's moments, summed over the ranks) and the
    train-mode parameter gradients; both ranks see the same result."""
    want = _unet_runs(_unet(use_simam), _images(32), None)
    for got in ranks2:
        _check_unet(got[f"unet_{use_simam}"], want)


def test_spatial_unet_four_ranks(ranks4):
    """The same at 4 ranks (SimAM on, 64^2: a 1-row slab at the deepest
    level)."""
    want = _unet_runs(_unet(True), _images(64), None)
    for got in ranks4:
        _check_unet(got["unet"], want)


def test_spatial_unet_matches_jax(jax_unet, ranks2):
    """The port's 2-rank UNet against JAX's ``spatial_unet_apply`` on a
    2-device mesh, the same weights: eval and train mode."""
    for got in ranks2:
        for mode in (False, True):
            np.testing.assert_allclose(got["jax"][mode].numpy(), jax_unet[1][mode],
                                       atol=TOL_FWD, rtol=TOL_FWD, err_msg=str(mode))


def test_spatial_stripe_attention_matches_plain(ranks2):
    """Horizontal stripes (slab-local), vertical stripes and the global
    window (K and V gathered) on 2 ranks against the plain attention of the
    whole grid: the output, the gradients of q, k, v and the LePE kernel,
    and at attention dropout 0.3 the output of the same mask."""
    want = _attn_runs(None)
    for got in ranks2:
        for geom, w in want.items():
            g = got["attention"][geom]
            for a, b, what in [(g["out"], w["out"], "out"), (g["drop"], w["drop"], "drop"),
                               *zip(g["grads"], w["grads"], ("dq", "dk", "dv", "dw"))]:
                gap = float((a - b).abs().max())
                assert gap <= TOL_ATTN * max(1.0, float(b.abs().max())), (geom, what, gap)
            assert float((w["drop"] - w["out"]).abs().max()) > 1e-2, geom


def test_validate_spatial_geometry_message():
    """JAX's message: H must divide by n_shards * 2^levels."""
    validate_spatial_geometry(64, 4)
    with pytest.raises(ValueError, match=r"H divisible by n_shards \* 2\^levels = 32 "
                                         r"\(got H=48, n_shards=2\)"):
        validate_spatial_geometry(48, 2)
    with pytest.raises(ValueError, match="n_shards"):
        spatial_unet_apply(UNet(base_features=4, device="cpu"), _images(32)[:, :24],
                           Mesh(1, 0, torch.device("cpu"), ("spatial",)))


def test_spatial_mesh_and_its_refusal_by_the_step():
    """``make_mesh((1,), ('spatial',))`` names its axis; the training step,
    the eval step and ``fit`` refuse a spatial mesh and name the spatial
    forwards; an axis the port has no mesh for is refused."""
    mesh = make_mesh((1,), ("spatial",), device="cpu")
    assert (mesh.size, mesh.rank, mesh.axis_names, mesh.shape) == (1, 0, ("spatial",),
                                                                   {"spatial": 1})
    with pytest.raises(ValueError, match="the port's meshes are"):
        make_mesh((1,), ("model",), device="cpu")
    model = CSWinUNet(img_size=64, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2),
                      num_heads=(2, 2, 2, 2), device="cpu")
    opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
    match = "spatial_unet_apply or parallel.spatial_cswin_apply"
    with pytest.raises(ValueError, match=match):
        engine.make_train_step(model, opt, mesh=mesh)
    with pytest.raises(ValueError, match=match):
        engine.make_eval_step(model, mesh=mesh)
    with pytest.raises(ValueError, match=match):
        engine.fit(model, opt, [], [], engine.FitConfig(num_epochs=1, verbose=False), mesh=mesh)
