"""PyTorch port, tensor parallelism over ``('data', 'model')`` meshes on the
CPU over gloo: ``parallel.params_shardings`` and ``shard_state`` split the
CSWin blocks' qkv, proj, fc1, fc2 and ``get_v`` (and their AdamW moments)
over the model axis, and the forward, the training step and
``gather_state`` run on the shards.

JAX's tiny geometry (64^2, embed 16, depth (1, 1, 1, 1), split (1, 2, 2,
2)) with heads (2, 4, 4, 4): as in the flagship, stage 1's branches hold
one head each, so at m = 2 stage 1's attention and its decoder twin's stay
replicated while every MLP and every other attention group splits.  One
spawn of 2 ranks, a (1, 2) mesh, and one of 4, a (2, 2) mesh (JAX's
hybrid layout), make every run (``run_ranks``, one torch thread a rank);
the tests read them:

* the forward in eval and in train mode (drops 0.3) against one process's,
  logits within 1e-5 x max(1, max|ref|);
* one AdamW step at drops 0.3 against one process (on the (2, 2) mesh, one
  process computing each data rank's rows with that rank's dropout stream
  and averaging): gathered gradients within 1e-4 x max(1, max|g|), updated
  parameters and AdamW moments within 1e-4 (JAX's bound,
  ``__graft_entry__.py:109-114``), loss, Dice and IoU;
* what each rank holds: its shards' shapes, its branches' heads and
  ``head0``, the replicated parameters, gradients and moments bit-identical
  over its model group, the split ones over its data group; the count of
  its model-group all-reduces;
* ``shard_state`` -> ``gather_state`` gives the state back;
* a UNet (no rule matches it) trained on (2, 2) against one process;
* once, the 4-rank step (drops 0, SGD at lr 1) against JAX's step on a
  ``(2, 2)`` ``('data', 'model')`` mesh of the simulated CPU devices with
  JAX's ``params_shardings``: the loss and every updated parameter within
  2e-4 x max(1, max|ref|).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cswin_simam_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_simam_unet_tpu.parallel import (batch_sharding as jax_batch_sharding,
                                           make_mesh as jax_make_mesh,
                                           params_shardings as jax_params_shardings,
                                           shard_state as jax_shard_state)
from cswin_simam_unet_tpu.train import engine as jax_engine

from cswin_simam_unet_tpu_torch.compat import cswin_state_dict
from cswin_simam_unet_tpu_torch.models import CSWinUNet, UNet
from cswin_simam_unet_tpu_torch.parallel import (collectives, gather_state, gather_tensor,
                                                 make_mesh, params_shardings, replicas_equal,
                                                 run_ranks, shard_state)
from cswin_simam_unet_tpu_torch.train import engine

from test_torch_port_train import _flax_variables

GEO = dict(img_size=64, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2),
           num_heads=(2, 4, 4, 4))
DROPS = dict(drop_rate=0.3, attn_drop_rate=0.3, drop_path_rate=0.3)
MESHES = {2: (1, 2), 4: (2, 2)}
TOL_FWD = 1e-5    # x max(1, max|ref|)
TOL_GRAD = 1e-4   # x max(1, max|g|)
TOL_STATE = 1e-4  # absolute: __graft_entry__.py:109-114
TOL_JAX = 2e-4    # x max(1, max|ref|), the model tolerance of the JAX comparisons
RNG = 9
MOMENTS = ("exp_avg", "exp_avg_sq")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n: int, img: int = 64):
    """n uint8 images and binary (0/255) disc masks."""
    rs = np.random.RandomState(4)
    images = rs.randint(0, 256, (n, img, img, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:img, :img]
    masks = np.stack([((yy - img // 3 - 4 * i) ** 2 + (xx - img // 2) ** 2 < img * 4)
                      for i in range(n)])
    return images, (masks[..., None] * 255).astype(np.uint8)


def _images() -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))


def _model(**kw) -> CSWinUNet:
    return CSWinUNet(**GEO, use_simam=True, device="cpu", **kw)


def _forwards(model) -> dict:
    x = _images()
    with torch.no_grad():
        return {"eval": model(x), "train": model(x, train=True, rng=RNG)}


def _tp_cswin(mesh) -> dict:
    """The CSWin runs of one rank on ``mesh``: forwards, the round trip, an
    AdamW step at drops 0.3 and what the rank holds."""
    model = _model(**DROPS)
    opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
    whole = {n: t.clone() for n, t in model.state_dict().items()}
    shardings = params_shardings(model, mesh)
    shard_state(model, opt, mesh, shardings)
    out = {"round_trip": all(torch.equal(t, whole[n])
                             for n, t in gather_state(model, None, mesh)[0].items())}
    out.update(_forwards(model))
    d = mesh.shape["data"]
    metrics = engine.make_train_step(model, opt, mesh=mesh)(*_batch(2 * d), rng=RNG)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["grads"] = {n: gather_tensor(model, n, p.grad, mesh)
                    for n, p in model.named_parameters()}
    out["collectives"] = collectives(model)
    state, moments = gather_state(model, opt, mesh)
    out["state"] = state
    out["moments"] = {n: {k: m[k] for k in MOMENTS} for n, m in moments.items()}
    split = {n for n, s in shardings.items() if not s.replicated}
    params = dict(model.named_parameters())
    held = {n: [p, p.grad, *(opt.state[p][k] for k in MOMENTS)] for n, p in params.items()}
    out["shapes"] = {n: tuple(p.shape) for n, p in params.items()}
    out["heads"] = {n: (m.num_heads, m.head0) for n, m in model.named_modules()
                    if type(m).__name__ == "LePEAttention"}
    out["model_replicas"] = replicas_equal(
        [t for n, ts in held.items() if n not in split for t in ts], mesh.along("model"))
    out["data_replicas"] = replicas_equal(
        [t for n, ts in held.items() if n in split for t in ts], mesh.along("data"))
    return out


def _tp_jax(mesh, jax_state: dict) -> dict:
    """The 4-rank step of the JAX comparison: drops 0, JAX's weights, SGD
    at lr 1."""
    model = _model()
    model.load_state_dict(jax_state)
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    shard_state(model, opt, mesh, params_shardings(model, mesh))
    metrics = engine.make_train_step(model, opt, mesh=mesh)(*_batch(4), rng=0)
    return {"loss": float(metrics["loss"]), "state": gather_state(model, None, mesh)[0]}


def _unet_step(mesh=None) -> dict:
    model = UNet(base_features=8, device="cpu")
    # SGD: Adam would scale the noise gradients of the conv biases before a
    # BatchNorm (zero in exact arithmetic) up to the learning rate
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    if mesh is not None:
        shard_state(model, opt, mesh, params_shardings(model, mesh))
    images, masks = _batch(4, 32)
    metrics = engine.make_train_step(model, opt, mesh=mesh)(images, masks, rng=RNG)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {n: t.clone() for n, t in model.state_dict().items()}}


def _ranks(rank: int, shape, jax_state) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {"coords": (mesh.along("data").rank, mesh.along("model").rank),
           "cswin": _tp_cswin(mesh)}
    if jax_state is not None:
        out["jax"] = _tp_jax(mesh, jax_state)
        out["unet"] = _unet_step(mesh)
    return out


@pytest.fixture(scope="module")
def jax_hybrid():
    """JAX's weights (as the port's state dict) and JAX's step on a (2, 2)
    ('data', 'model') mesh with its params_shardings: (state, loss,
    updated state)."""
    jm = JaxCSWinUNet(**GEO, use_simam=True)
    variables = _flax_variables(jm, np.random.RandomState(6))
    mesh = jax_make_mesh((2, 2), ("data", "model"), jax.devices()[:4])
    state = jax_engine.TrainState.create(apply_fn=jm.apply, params=variables["params"],
                                         tx=optax.sgd(1.0))
    state = jax_shard_state(state, mesh, jax_params_shardings(state.params, mesh))
    images, masks = (jax.device_put(a, jax_batch_sharding(mesh, 4)) for a in _batch(4))
    step = jax_engine.make_train_step(jm, n_classes=1, augment=None, donate=False)
    new_state, metrics = step(state, images, masks, jax.random.PRNGKey(0))
    to_port = lambda p: {n: torch.from_numpy(np.array(v, dtype=np.float32))  # noqa: E731
                         for n, v in cswin_state_dict({"params": p}, GEO["depth"]).items()}
    return (to_port(jax.device_get(variables["params"])), float(metrics["loss"]),
            to_port(jax.device_get(new_state.params)))


@pytest.fixture(scope="module")
def runs(jax_hybrid, tmp_path_factory):
    """{ranks: each rank's results} of the two spawns."""
    return {n: run_ranks(_ranks, n, (MESHES[n], jax_hybrid[0] if n == 4 else None),
                         device="cpu", store_dir=str(tmp_path_factory.mktemp(f"store{n}")))
            for n in MESHES}


@pytest.fixture(scope="module")
def one_process():
    """The one-process references: the forwards of the drops-0.3 model,
    and its AdamW step on each mesh's global batch as the data ranks take
    it (rank i's rows with rank i's dropout stream, gradients averaged)."""
    out = {}
    for n, (d, _) in MESHES.items():
        model = _model(**DROPS)
        opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
        ref = _forwards(model)
        images, masks = _batch(2 * d)
        opt.zero_grad(set_to_none=True)
        sums = 0.0
        losses = []
        for i in range(d):
            rows = slice(2 * i, 2 * i + 2)
            loss, logits, targets = engine.compute_gradients(
                model, images[rows], masks[rows], rng=RNG, weight=1.0 / d, rank=i)
            losses.append(float(loss))
            sums = sums + engine._metric_sums(logits, targets, 1)
        opt.step()
        dice, iou = engine._metrics_from_sums(sums)
        ref["metrics"] = {"loss": float(np.mean(losses)), "dice": float(dice), "iou": float(iou)}
        ref["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
        ref["state"] = model.state_dict()
        ref["moments"] = {n: {k: opt.state[p][k] for k in MOMENTS}
                          for n, p in model.named_parameters()}
        out[n] = ref
    return out


def _scaled_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("world", sorted(MESHES))
def test_forward_matches_one_process(runs, one_process, world):
    for r in runs[world]:
        for mode in ("eval", "train"):
            gap = _scaled_gap(r["cswin"][mode], one_process[world][mode])
            assert gap <= TOL_FWD, (r["coords"], mode, gap)
    assert not torch.equal(runs[world][0]["cswin"]["eval"], runs[world][0]["cswin"]["train"])


@pytest.mark.parametrize("world", sorted(MESHES))
def test_step_matches_one_process(runs, one_process, world):
    ref = one_process[world]
    for r in runs[world]:
        got = r["cswin"]
        for k, v in ref["metrics"].items():
            assert abs(got["metrics"][k] - v) <= TOL_STATE * max(1.0, abs(v)), (k, got["metrics"])
        for name, g in ref["grads"].items():
            assert _scaled_gap(got["grads"][name], g) <= TOL_GRAD, (r["coords"], name)
        for name, t in ref["state"].items():
            assert float((got["state"][name] - t).abs().max()) <= TOL_STATE, name
        for name, m in ref["moments"].items():
            for k in MOMENTS:
                assert float((got["moments"][name][k] - m[k]).abs().max()) <= TOL_STATE, (name, k)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_each_rank_holds_its_shards(runs, one_process, world):
    """Each model rank holds half of qkv, proj, fc1, fc2 and get_v where they
    split, its branches half the heads from head0 = its coordinate x that
    half; replicated state bit-identical over the model group, split state
    over the data group; 14 model-group all-reduces a forward (2 in each of
    the 6 blocks whose attention splits, 1 in the 2 whose MLP alone does)
    and 14 a backward: two forwards and a step, 56."""
    whole = {n: tuple(t.shape) for n, t in one_process[world]["state"].items()}
    model = _model()
    for r in runs[world]:
        got, (_, j) = r["cswin"], r["coords"]
        assert got["model_replicas"] and got["data_replicas"]
        assert got["collectives"]["all_reduces"] == 56
        for name, shape in got["shapes"].items():
            halved = [a != b for a, b in zip(shape, whole[name])]
            if any(halved):
                assert name.endswith(("qkv.weight", "qkv.bias", "proj.weight", "fc1.weight",
                                      "fc1.bias", "fc2.weight", "get_v.weight", "get_v.bias"))
                dim = halved.index(True)
                assert sum(halved) == 1 and shape[dim] * 2 == whole[name][dim]
        for name, (heads, head0) in got["heads"].items():
            full = model.get_submodule(name).num_heads
            assert (heads, head0) == ((full, 0) if full % 2 else (full // 2, j * full // 2))
        split = sum(any(a != b for a, b in zip(s, whole[n])) for n, s in got["shapes"].items())
        assert split == 6 * 10 + 2 * 8 - 2 * 7  # stage 1's two attention groups replicated


def test_shard_gather_round_trip(runs):
    assert all(r["cswin"]["round_trip"] for rs in runs.values() for r in rs)


def test_unet_on_a_hybrid_mesh(runs):
    """A UNet on (2, 2): replicated over the model axis, its batch and its
    BatchNorm moments over the data axis: one process's step."""
    ref = _unet_step()
    for r in runs[4]:
        got = r["unet"]
        for k, v in ref["metrics"].items():
            assert abs(got["metrics"][k] - v) <= TOL_STATE * max(1.0, abs(v)), k
        for name, t in ref["state"].items():
            assert _scaled_gap(got["state"][name].double(), t.double()) <= TOL_STATE, name


def test_four_ranks_match_jax_hybrid_step(runs, jax_hybrid):
    _, loss, want = jax_hybrid
    for r in runs[4]:
        got = r["jax"]
        assert abs(got["loss"] - loss) <= TOL_JAX * max(1.0, abs(loss))
        worst = max(_scaled_gap(got["state"][n], t) for n, t in want.items())
        assert worst <= TOL_JAX, worst
