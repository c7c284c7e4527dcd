"""PyTorch port, data parallelism: the mesh, the sharded step and the
replicated state, with two ranks over gloo on the CPU.

The ranks are processes (``parallel.run_ranks``: the ``spawn`` start
method, a ``file://`` store in the test's temporary directory, so that no
port is taken and test workers never collide), each at one torch thread.
A spawned rank imports this module by name, so it imports torch and the
port only: JAX is imported inside the two tests that compare with it.

A 2-rank step is held against the 1-process step on the global batch (4
images, 2 a rank): the UNet at JAX's test width (``base_features=4``,
16^2, Adam at lr 1e-6 as in ``tests/test_parallel.py``), whose BatchNorm
sums its moments over the ranks; the tiny CSWin-UNet at drops 0 with
``grad_accum=2``; and its 4-class head with augmentation.  The loss within
``TOL_LOSS`` relative, Dice and IoU within ``TOL_COUNTS``, every gradient
within ``TOL_GRAD`` of its own max, each parameter after the step within
two Adam steps, the running statistics within ``TOL_STATS``, and the two
ranks' parameters and buffers bit-identical.  Once, the 2-rank UNet step against JAX's step on a
2-device mesh with ``test_parallel.py``'s tolerances.  A 1-rank mesh step
equals the step without a mesh bit for bit.
"""

import numpy as np
import pytest
import torch

from cswin_simam_unet_tpu_torch.data import AugmentConfig
from cswin_simam_unet_tpu_torch.models import CSWinUNet, UNet
from cswin_simam_unet_tpu_torch.parallel import (batch_sharding, make_mesh, process_local_indices,
                                                 replicas_equal, run_ranks, shard_state)
from cswin_simam_unet_tpu_torch.parallel.mesh import Mesh, state_tensors
from cswin_simam_unet_tpu_torch.train import engine

TINY = dict(img_size=64, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2),
            num_heads=(2, 2, 4, 8))
DROPS = dict(drop_rate=0.3, attn_drop_rate=0.3, drop_path_rate=0.3)
WORLD = 2
BATCH = 4                # the global batch: 2 rows a rank
RNG = 1234               # the step's seed
# float32, 2 ranks against 1 process: the same sums in another order (the
# gradient average, BatchNorm's moments by E[x^2] - E[x]^2 over the ranks
# against torch's two-pass moments over the batch)
TOL_LOSS = 1e-5          # relative
TOL_COUNTS = 1e-6        # Dice and IoU, absolute (the counts are integers)
TOL_GRAD = 2e-4          # x the gradient's own max|.|, per tensor (measured: 2.8e-5)
TOL_STATS = 1e-5         # running statistics, x max(1, max|1 process|)
# Adam's first step moves an entry by about lr x sign(g): where g is within
# rounding of 0 (or of -wd p, under the UNet's L2-coupled decay) it goes
# either way, so a parameter is held within two steps (2 lr)
TOL_PARAM_LRS = 2
# the conv biases before a BatchNorm: the batch mean takes them out, so
# their gradient is rounding noise (about 1e-10 against 1e-3 elsewhere)
NOISE_BIASES = ("double_conv.0.bias", "double_conv.3.bias")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as in every rank (the test workers share the
    machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n_classes: int, img: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    images = (rs.rand(BATCH, img, img, 3) * 255).astype(np.uint8)
    if n_classes == 1:
        return images, ((images[..., :1] > 128) * 255).astype(np.uint8)
    return images, (images[..., :1] // 64).astype(np.uint8)


def _setup(name: str, seed: int = 0):
    """(model, optimizer, step keywords, images, masks) of a scenario, the
    same in every process; the learning rate is ``opt``'s."""
    if name == "unet":
        model = UNet(base_features=4, device="cpu", seed=seed)
        opt = engine.make_optimizer("adam", 1e-6, 1e-4, model.parameters())
        return (model, opt, {}, *_batch(1, 16))
    classes = 4 if name == "cswin_4class" else 1
    drops = DROPS if name == "dropout" else {}
    model = CSWinUNet(**TINY, num_classes=classes, use_simam=True, device="cpu", seed=seed,
                      **drops)
    opt = engine.make_optimizer("adamw", 1e-4, 1e-4, model.parameters())
    kw = {"cswin_accum": dict(grad_accum=2),
          "cswin_4class": dict(n_classes=4, augment=AugmentConfig(mask_nearest=True)),
          "dropout": dict(augment=AugmentConfig())}[name]
    return (model, opt, kw, *_batch(classes, 64))


def _record(model, metrics, mesh=None) -> dict:
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
           "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    if mesh is not None:
        out["replicas_equal"] = replicas_equal(state_tensors(model), mesh)
    return out


STEP_SCENARIOS = ("unet", "cswin_accum", "cswin_4class")


def _step_ranks(rank: int) -> dict:
    """Each rank: the 2-rank step of every scenario, the dropout scenario's
    captured inputs and logits, and ``shard_state`` over divergent ranks."""
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    out = {}
    for name in STEP_SCENARIOS:
        model, opt, kw, images, masks = _setup(name)
        step = engine.make_train_step(model, opt, mesh=mesh, **kw)
        out[name] = _record(model, step(images, masks, rng=RNG), mesh)

    model, opt, kw, images, masks = _setup("dropout")
    seen = []
    model.register_forward_hook(lambda m, args, y: seen.append((args[0].clone(), y.clone())))
    engine.make_train_step(model, opt, mesh=mesh, **kw)(images, masks, rng=RNG)
    out["dropout"] = seen[0]

    # divergent ranks: other weights, and an Adam state after a step of its own
    model, opt, kw, images, masks = _setup("unet", seed=rank)
    engine.make_train_step(model, opt, **kw)(images[rank::2], masks[rank::2], rng=rank)
    before = replicas_equal(state_tensors(model, opt), mesh)
    shard_state(model, opt, mesh)
    out["shard_state"] = dict(before=before, after=replicas_equal(state_tensors(model, opt), mesh),
                              state={k: v.clone() for k, v in model.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_step_ranks, WORLD, device="cpu",
                     store_dir=str(tmp_path_factory.mktemp("store")))


def _one_process(name: str) -> dict:
    model, opt, kw, images, masks = _setup(name)
    return _record(model, engine.make_train_step(model, opt, **kw)(images, masks, rng=RNG))


def _worst(got: dict, want: dict, floor: float = 0.0) -> tuple:
    """The largest |got - want| / max(floor, max|want|) over the tensors."""
    worst = (0.0, "")
    for k, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), k
            continue
        scale = max(floor, float(w.abs().max()), 1e-30)
        worst = max(worst, (float((got[k] - w).abs().max()) / scale, k))
    return worst


@pytest.mark.parametrize("name", STEP_SCENARIOS)
def test_two_rank_step_matches_one_process(ranks, name):
    """The 2-rank step equals the 1-process step on the global batch: the
    metrics, every all-reduced gradient, the update, the running statistics;
    and both ranks hold bit-identical parameters and buffers after it."""
    want = _one_process(name)
    init = _setup(name)[0].state_dict()
    for r, got in enumerate(ranks):
        got = got[name]
        assert got["replicas_equal"], name
        m, w = got["metrics"], want["metrics"]
        assert abs(m["loss"] - w["loss"]) <= TOL_LOSS * abs(w["loss"]), (r, m, w)
        for k in ("dice", "iou"):
            assert abs(m[k] - w[k]) <= TOL_COUNTS, (r, k, m, w)
        gap, where = _worst(got["grads"], {k: g for k, g in want["grads"].items()
                                           if not k.endswith(NOISE_BIASES)})
        assert gap <= TOL_GRAD, ("gradient", name, r, where, gap)
        model, opt = _setup(name)[:2]
        params = dict(model.named_parameters())
        lr = opt.param_groups[0]["lr"]
        for k in params:
            assert not torch.equal(got["state"][k], init[k]), ("not stepped", k)
            gap = float((got["state"][k] - want["state"][k]).abs().max())
            assert gap <= TOL_PARAM_LRS * lr, ("parameter", name, r, k, gap)
        buffers = {k: v for k, v in want["state"].items() if k not in params}
        gap, where = _worst({k: got["state"][k] for k in buffers}, buffers, floor=1.0)
        assert gap <= TOL_STATS, ("running statistics", name, r, where, gap)
    for k, v in ranks[0][name]["state"].items():
        assert torch.equal(v, ranks[1][name]["state"][k]), k


def test_ranks_draw_own_dropout_and_global_augmentation(ranks):
    """At drops 0.3 with augmentation: each rank's augmented rows are its
    rows of the 1-process step's augmented batch (the global batch's
    draws); rank 0 drops what a run without a mesh drops, rank 1 draws a
    stream of its own."""
    model, _, kw, images, masks = _setup("dropout")
    want_images, _ = engine._inputs(model, images, masks, 1, kw["augment"], RNG)
    for r in range(WORLD):
        got_images, got_logits = ranks[r]["dropout"]
        assert torch.equal(got_images, want_images[2 * r:2 * r + 2]), r
        own = model(got_images, flat_logits=True, train=True, rng=engine.rank_seed(RNG, r))
        assert torch.equal(got_logits, own), r
    rank0_stream = model(ranks[1]["dropout"][0], flat_logits=True, train=True, rng=RNG)
    assert not torch.allclose(ranks[1]["dropout"][1], rank0_stream)
    assert engine.rank_seed(RNG, 0) == RNG != engine.rank_seed(RNG, 1)


def test_shard_state_makes_divergent_ranks_equal(ranks):
    """Ranks with other weights and other Adam states hold rank 0's after
    ``shard_state``, bit for bit."""
    assert not ranks[0]["shard_state"]["before"]
    model, opt, kw, images, masks = _setup("unet", seed=0)  # rank 0's own state
    engine.make_train_step(model, opt, **kw)(images[0::2], masks[0::2], rng=0)
    for got in ranks:
        assert got["shard_state"]["after"]
        for k, v in model.state_dict().items():
            assert torch.equal(got["shard_state"]["state"][k], v), k


@pytest.mark.parametrize("name", ["unet", "dropout"])
def test_one_rank_mesh_step_equals_no_mesh(name):
    """A mesh of one rank changes nothing, bit for bit: the UNet, and the
    tiny CSWin-UNet at drops 0.3 with augmentation (rank 0's stream is the
    stream of a run without a mesh)."""
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"data": 1})
    results = []
    for m in (None, mesh):
        model, opt, kw, images, masks = _setup(name)
        step = engine.make_train_step(model, opt, mesh=m, **kw)
        results.append([_record(model, step(images, masks, rng=RNG + i)) for i in range(2)])
    for plain, meshed in zip(*results):
        assert plain["metrics"] == meshed["metrics"]
        for part in ("grads", "state"):
            for k, v in plain[part].items():
                assert torch.equal(v, meshed[part][k]), (part, k)


def test_process_local_indices_and_sharding_match_jax():
    """``process_local_indices`` equals JAX's for several (n, global batch,
    processes), ragged tails included; ``batch_sharding``'s rows split each
    global micro-batch (``grad_accum``) and leave a batch that does not
    split whole, as JAX places it replicated."""
    from cswin_simam_unet_tpu.parallel import process_local_indices as jax_local

    for n, gb, count in ((21, 8, 2), (22, 8, 2), (16, 8, 2), (13, 4, 1), (30, 12, 3),
                         (31, 12, 3), (7, 8, 2), (36, 12, 4)):
        idx = np.random.RandomState(n).permutation(n)
        for p in range(count):
            np.testing.assert_array_equal(process_local_indices(idx, gb, p, count),
                                          jax_local(idx, gb, process=p, count=count))
    with pytest.raises(ValueError, match="not divisible"):
        process_local_indices(np.arange(8), 3, 0, 2)

    def rows(rank, size, batch, accum=1):
        return list(batch_sharding(Mesh(size, rank, torch.device("cpu")),
                                   grad_accum=accum).rows(batch))
    assert [rows(r, 2, 8, 2) for r in range(2)] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert [rows(r, 2, 4) for r in range(2)] == [[0, 1], [2, 3]]
    assert rows(1, 2, 3) == [0, 1, 2] and rows(1, 2, 6, 2) == list(range(6))


def _jax_ranks(rank: int, state: dict, images, masks) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    model = UNet(base_features=4, device="cpu")
    model.load_state_dict(state, strict=True)
    opt = engine.make_optimizer("adam", 1e-6, 1e-4, model.parameters())
    metrics = engine.make_train_step(model, opt, mesh=mesh)(images, masks, rng=RNG)
    return _record(model, metrics, mesh)


def test_two_rank_unet_step_matches_jax_mesh(tmp_path):
    """The port's 2-rank UNet step against JAX's ``make_train_step`` on a
    2-device mesh from the same weights and batch (``test_parallel.py``'s
    check): the loss within rtol 1e-5, the parameters within rtol 1e-4 /
    atol 1e-5, and the running statistics within ``TOL_STATS``."""
    import jax
    from cswin_simam_unet_tpu.models import UNet as JaxUNet
    from cswin_simam_unet_tpu.parallel import batch_sharding as jax_batch_sharding
    from cswin_simam_unet_tpu.parallel import make_mesh as jax_make_mesh
    from cswin_simam_unet_tpu.parallel import replicated as jax_replicated
    from cswin_simam_unet_tpu.parallel import shard_state as jax_shard_state
    from cswin_simam_unet_tpu.train.engine import create_train_state, make_train_step
    from cswin_simam_unet_tpu_torch.compat import load_flax_params, unet_state_dict

    jm = JaxUNet(base_features=4)
    state = create_train_state(jm, jax.random.PRNGKey(0), (1, 16, 16, 3), "adam", 1e-6, 1e-4)
    port = UNet(base_features=4, device="cpu")
    load_flax_params(port, {"params": state.params, "batch_stats": state.batch_stats})
    images, masks = _batch(1, 16)
    mesh = jax_make_mesh((WORLD,), devices=jax.devices()[:WORLD])
    bs = jax_batch_sharding(mesh, 4)
    new, m = make_train_step(jm, augment=None, donate=False)(
        jax_shard_state(state, mesh), jax.device_put(images, bs), jax.device_put(masks, bs),
        jax.device_put(jax.random.PRNGKey(1), jax_replicated(mesh)))
    want = unet_state_dict({"params": new.params, "batch_stats": new.batch_stats})
    got = run_ranks(_jax_ranks, WORLD, (port.state_dict(), images, masks), device="cpu",
                    store_dir=str(tmp_path))
    for r in got:
        assert r["replicas_equal"]
        np.testing.assert_allclose(r["metrics"]["loss"], float(m["loss"]), rtol=1e-5)
        for k, v in want.items():
            v = np.asarray(v)
            if k.endswith("num_batches_tracked"):  # JAX keeps no count
                continue
            if k.endswith(("running_mean", "running_var")):
                scale = max(1.0, float(np.abs(v).max()))
                assert float(np.abs(r["state"][k].numpy() - v).max()) <= TOL_STATS * scale, k
            else:
                np.testing.assert_allclose(r["state"][k].numpy(), v, rtol=1e-4, atol=1e-5,
                                           err_msg=k)
