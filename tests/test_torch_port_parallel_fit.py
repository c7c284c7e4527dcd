"""PyTorch port, data parallelism through ``fit``, checkpoints and the CLI,
with two ranks over gloo on the CPU (``parallel.run_ranks``, a ``file://``
store under the test's temporary directory, one torch thread a rank).  No
JAX here: ``test_torch_port_parallel.py`` holds the step against JAX.

``fit`` of the UNet at JAX's test width (``base_features=4``, 16^2,
L2-coupled Adam at lr 1e-6, augmented) over 2 epochs of 11 training images
in batches of 4 and 5 test images (the last batch of each, 3 and 1 rows,
does not split over 2 ranks and is computed whole by both), from a sharded
``DataLoader`` (each rank decodes its rows) and a loader of global batches
(``device_prefetch`` takes the rows): the history follows the 1-process
history within rtol 1e-5 (loss) and 1e-4 (Dice, IoU), as
``tests/test_parallel.py`` holds JAX's mesh, and the ranks end with
bit-identical parameters and BatchNorm buffers.  Rank 0 alone writes the
checkpoints; a 2-rank run resumed from epoch 1 follows the unbroken one
bit for bit.  The CLI under 2 ranks at the UNet's smallest image size
(16^2): rank 0 alone prints and writes, and a batch that does not divide
over the ranks prints JAX's message and trains as one process would.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import cv2

from cswin_simam_unet_tpu_torch import cli
from cswin_simam_unet_tpu_torch.compat.io import load_state_dict_file, load_state_dict_strict
from cswin_simam_unet_tpu_torch.configs import build_model
from cswin_simam_unet_tpu_torch.data import AugmentConfig, DataLoader
from cswin_simam_unet_tpu_torch.models import UNet
from cswin_simam_unet_tpu_torch.parallel import (batch_sharding, make_mesh, replicas_equal,
                                                 run_ranks)
from cswin_simam_unet_tpu_torch.parallel.mesh import state_tensors
from cswin_simam_unet_tpu_torch.train import engine
from cswin_simam_unet_tpu_torch.train.checkpoint import CheckpointStore
from cswin_simam_unet_tpu_torch.train.schedule import make_plateau_scheduler

WORLD = 2
IMG = 16
N_TRAIN, N_TEST, BATCH = 11, 5, 4
EPOCHS = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as in every rank (the test workers share the
    machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Memory:
    """An in-memory source of uint8 (image, mask) pairs for ``DataLoader``;
    it records which samples it loaded."""

    def __init__(self, n: int, seed: int):
        rs = np.random.RandomState(seed)
        self.images = (rs.rand(n, IMG, IMG, 3) * 255).astype(np.uint8)
        self.masks = ((self.images[..., :1] > 128) * 255).astype(np.uint8)
        self.loaded = []

    def __len__(self):
        return len(self.images)

    def load(self, i):
        self.loaded.append(int(i))
        return self.images[i], self.masks[i]

    def load_batch(self, idx):
        return None


class _GlobalBatches:
    """A loader of global batches (the test split), in a fixed order."""

    def __init__(self, source):
        self.source = source

    def __iter__(self):
        n = len(self.source)
        return iter([(self.source.images[i:i + BATCH], self.source.masks[i:i + BATCH])
                     for i in range(0, n, BATCH)])


def _fit(mesh, store_dir=None, resume_from=None) -> dict:
    """A 2-epoch augmented ``fit`` of the small UNet; with ``resume_from``
    (a checkpoint directory) a fresh model and optimizer restore epoch 1
    and train epoch 2."""
    model = UNet(base_features=4, device="cpu", seed=0)
    opt = engine.make_optimizer("adam", 1e-6, 1e-4, model.parameters())
    train_src = _Memory(N_TRAIN, 1)
    sharding = batch_sharding(mesh) if mesh is not None else None
    train = DataLoader(train_src, batch_size=BATCH, shuffle=True, num_workers=1, seed=3,
                       sharding=sharding)
    test = _GlobalBatches(_Memory(N_TEST, 2))
    store = CheckpointStore(store_dir) if store_dir else None
    saves = []
    if store is not None:
        save = store.save_epoch
        store.save_epoch = lambda epoch, *a, **k: (saves.append(epoch), save(epoch, *a, **k))
    scheduler = make_plateau_scheduler(opt, 0.5, 0, 1e-7)
    kw = {}
    if resume_from is not None:
        sched_state, history, epoch, step = CheckpointStore(resume_from).restore(model, opt, 1)
        scheduler.load_state_dict(sched_state)
        kw = dict(history=history, start_epoch=epoch, global_step=step)
    cfg = engine.FitConfig(num_epochs=EPOCHS, augment=AugmentConfig(), verbose=False, seed=5,
                           checkpoint_manager=store)
    history, _ = engine.fit(model, opt, train, test, cfg, scheduler=scheduler, mesh=mesh, **kw)
    out = {"history": history, "state": {k: v.clone() for k, v in model.state_dict().items()},
           "saves": saves, "loaded": sorted(train_src.loaded)}
    if mesh is not None:
        out["replicas_equal"] = replicas_equal(state_tensors(model, opt), mesh)
    return out


def _fit_ranks(rank: int, root: str) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    unbroken = _fit(mesh, os.path.join(root, "ckpt"))
    return {"unbroken": unbroken,
            "resumed": _fit(mesh, resume_from=os.path.join(root, "ckpt"))}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    return run_ranks(_fit_ranks, WORLD, (str(root),), device="cpu", store_dir=str(root))


def test_two_rank_fit_follows_one_process(fits):
    """Augmented, with a ragged last batch in training and in test: the
    2-rank history follows the 1-process one, the ranks end bit-identical,
    each rank decoded only its rows of each split batch (and the ragged
    batch whole), and rank 0 alone saved the checkpoints."""
    want = _fit(None)["history"]
    for r, got in enumerate(fits):
        got = got["unbroken"]
        h = got["history"]
        np.testing.assert_allclose(h["train_loss"], want["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(h["test_loss"], want["test_loss"], rtol=1e-5)
        for k in ("train_dice", "train_iou", "test_dice", "test_iou"):
            np.testing.assert_allclose(h[k], want[k], rtol=1e-4, err_msg=k)
        assert h["learning_rates"] == want["learning_rates"]
        assert got["replicas_equal"]
        assert got["saves"] == (list(range(1, EPOCHS + 1)) if r == 0 else [])
        # 2 full batches split (2 rows each) and the ragged one whole, each epoch
        assert len(got["loaded"]) == EPOCHS * (2 * BATCH // WORLD + N_TRAIN % BATCH)
    for k, v in fits[0]["unbroken"]["state"].items():
        assert torch.equal(v, fits[1]["unbroken"]["state"][k]), k


def test_resumed_two_rank_fit_follows_unbroken(fits):
    """Every rank restores epoch 1 from rank 0's files into a fresh model
    and optimizer and trains epoch 2: the same history and state as the
    unbroken 2-rank run, bit for bit."""
    for got in fits:
        assert got["resumed"]["history"] == got["unbroken"]["history"]
        for k, v in got["unbroken"]["state"].items():
            assert torch.equal(got["resumed"]["state"][k], v), k


@pytest.fixture(scope="module")
def discs(tmp_path_factory):
    root = tmp_path_factory.mktemp("discs")
    rs = np.random.RandomState(0)
    for sub in ("images", "masks"):
        (root / sub).mkdir()
    yy, xx = np.mgrid[:32, :32]
    for i in range(8):
        img = (rs.rand(32, 32, 3) * 120).astype(np.uint8)
        disc = (yy - rs.randint(10, 22)) ** 2 + (xx - rs.randint(10, 22)) ** 2 < 40
        img[disc] = 230
        cv2.imwrite(str(root / "images" / f"im_{i}.jpg"), img)
        cv2.imwrite(str(root / "masks" / f"im_{i}.jpg"), disc.astype(np.uint8) * 255)
    return root


def _cli_ranks(rank: int, root: str) -> dict:
    """``train`` under the group of this run: batch 2 (split, 1 a rank) and
    batch 3 (no split); what each rank printed and wrote."""
    torch.set_num_threads(1)
    written = []
    for name in ("save_weights", "save_metrics_to_csv", "plot_metrics"):
        real = getattr(cli, name)
        setattr(cli, name, lambda *a, _real=real, _name=name, **k: (written.append(_name),
                                                                     _real(*a, **k)))
    save_epoch = CheckpointStore.save_epoch
    CheckpointStore.save_epoch = lambda self, *a, **k: (written.append("save_epoch"),
                                                        save_epoch(self, *a, **k))
    runs = {}
    for batch in (2, 3):
        del written[:]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli.main(["train", "--config", "unet_256", "--image-size", str(IMG),
                             "--device", "cpu", "--epochs", "1", "--batch-size", str(batch),
                             "--no-progress", "--image-dir", os.path.join(root, "images"),
                             "--mask-dir", os.path.join(root, "masks"),
                             "--output-dir", os.path.join(root, f"out{batch}")])
        runs[batch] = {"code": code, "stdout": out.getvalue(), "written": sorted(set(written))}
    return runs


def test_cli_two_ranks(discs, tmp_path):
    """Batch 2 splits over 2 ranks (the banner says so): rank 0 alone
    prints and writes, and the weights load strictly.  Batch 3 does not
    divide: JAX's message, and rank 0 trains alone as one process would."""
    got = run_ranks(_cli_ranks, WORLD, (str(discs),), device="cpu", store_dir=str(tmp_path))
    r0, r1 = got
    assert r0[2]["code"] == r1[2]["code"] == 0
    assert "{'data': 2} (2 ranks)" in r0[2]["stdout"] and "Done." in r0[2]["stdout"]
    assert r1[2]["stdout"] == "" and r1[2]["written"] == []
    assert {"save_weights", "save_metrics_to_csv", "save_epoch"} <= set(r0[2]["written"])
    weights = os.path.join(discs, "out2", "unet_256_final_weights.pth")
    load_state_dict_strict(build_model("unet_256", device="cpu"), load_state_dict_file(weights))

    assert r0[3]["code"] == r1[3]["code"] == 0
    assert ("data_parallel requested but batch_size 3 is not divisible by 2 devices; "
            "training single-device") in r0[3]["stdout"]
    assert "mesh: single-device" in r0[3]["stdout"] and "Done." in r0[3]["stdout"]
    assert r1[3]["stdout"] == "" and r1[3]["written"] == []
    assert os.path.exists(os.path.join(discs, "out3", "unet_256_final_weights.pth"))


def test_single_process_runtime_and_refusals(monkeypatch):
    """One process: ``initialize_runtime`` is a no-op and the mesh has one
    rank.  The tensor-parallel half: a (1, 1) ``('data', 'model')`` mesh
    with its two one-rank axes, and ``state_sharding`` with
    ``params_shardings``, under which a UNet (no rule matches it) is
    replicated whole; a mesh that is not the world's is refused."""
    from cswin_simam_unet_tpu_torch.parallel import (global_batch_from_local,
                                                     initialize_runtime, params_shardings,
                                                     replicated, state_sharding)
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_runtime() == (0, 1)
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.is_main, mesh.shape) == (1, True, {"data": 1})
    hybrid = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert (hybrid.size, hybrid.is_main, hybrid.shape) == (1, True, {"data": 1, "model": 1})
    assert [(m.size, m.rank, m.axis_names) for m in map(hybrid.along, ("data", "model"))] == [
        (1, 0, ("data",)), (1, 0, ("model",))]
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh((2,), device="cpu")
    with pytest.raises(ValueError, match="needs 4 processes"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    model = UNet(base_features=4, device="cpu")
    shardings = state_sharding(model, hybrid, params_shardings(model, hybrid))
    assert set(shardings) == set(model.state_dict())
    assert all(s.replicated for s in shardings.values())
    assert set(state_sharding(model, mesh)) == set(model.state_dict())
    assert list(replicated(mesh).rows(3)) == [0, 1, 2]
    x = np.arange(12, dtype=np.uint8).reshape(3, 4)
    assert torch.equal(global_batch_from_local(x, mesh), torch.from_numpy(x))


def test_loader_and_prefetch_take_each_ranks_rows():
    """Without a process group (the rows are a function of rank and size):
    over the ranks, the sharded ``DataLoader`` and ``device_prefetch`` of
    global batches give every row of each split batch once, share i of
    every micro-batch with ``grad_accum``, a batch that does not split
    whole on every rank, and each batch's global size."""
    from cswin_simam_unet_tpu_torch.data import device_prefetch
    from cswin_simam_unet_tpu_torch.parallel import Mesh

    src = _Memory(N_TRAIN, 0)  # batches of 4, 4 and 3
    for accum in (1, 2):
        per_rank = []
        for rank in range(WORLD):
            sharding = batch_sharding(Mesh(WORLD, rank, torch.device("cpu")), grad_accum=accum)
            loader = DataLoader(src, batch_size=BATCH, num_workers=1, sharding=sharding)
            from_loader = list(loader)
            prefetched = list(device_prefetch(_GlobalBatches(src), "cpu", sharding=sharding))
            for (a, _, n), (b, _, m) in zip(from_loader, prefetched):
                assert n == m and np.array_equal(a, b.numpy())
            per_rank.append(from_loader)
        for i in range(3):
            (a, _, n), (b, _, _) = per_rank[0][i], per_rank[1][i]
            batch = src.images[i * BATCH:(i + 1) * BATCH]
            assert n == len(batch)
            if i == 2:
                assert np.array_equal(a, batch) and np.array_equal(b, batch)
                continue
            k = n // (accum * WORLD)
            for j in range(accum):  # micro-batch j: rank 0's share, then rank 1's
                got = np.concatenate([a[j * k:(j + 1) * k], b[j * k:(j + 1) * k]])
                assert np.array_equal(got, batch[j * 2 * k:(j + 1) * 2 * k])
