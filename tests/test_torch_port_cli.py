"""PyTorch port, the command line on the CPU (``--device cpu``):
``cswin_tiny_224`` at ``--image-size 64`` over eight cv2-written JPEG pairs
trains 2 epochs (CSV, plot, final weights, checkpoints), resumes along the
unbroken run's history, evaluates the best weights on the test split to the
history's numbers (1e-6: they are printed with 6 decimals), predicts masks,
exports a ``.pth`` that loads strictly, lists the configs, and refuses what
is not ported with an error that says so.  No JAX here: the CLI's parts are
held against JAX in ``test_torch_port_data.py``.
"""

import contextlib
import csv
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import cv2

from cswin_simam_unet_tpu_torch import cli
from cswin_simam_unet_tpu_torch.compat.io import load_state_dict_file, load_state_dict_strict
from cswin_simam_unet_tpu_torch.configs import CONFIGS, build_model

ARGS = ["--config", "cswin_tiny_224", "--image-size", "64", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops (the test workers
    share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rs = np.random.RandomState(0)
    for sub in ("images", "masks"):
        (root / sub).mkdir()
    yy, xx = np.mgrid[:48, :48]
    for i in range(8):
        img = (rs.rand(48, 48, 3) * 120).astype(np.uint8)
        disc = (yy - rs.randint(14, 34)) ** 2 + (xx - rs.randint(14, 34)) ** 2 < 100
        img[disc] = 230
        cv2.imwrite(str(root / "images" / f"im_{i}.jpg"), img)
        cv2.imwrite(str(root / "masks" / f"im_{i}.jpg"), disc.astype(np.uint8) * 255)
    return root, ["--image-dir", str(root / "images"), "--mask-dir", str(root / "masks")]


def _history(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def trained(data):
    root, dirs = data
    out = root / "out"
    log = _run(["train", *ARGS, *dirs, "--output-dir", str(out), "--epochs", "2",
                "--no-progress"])
    return out, dirs, log


def test_train_writes_its_artifacts(trained):
    out, _, log = trained
    assert "config: cswin_tiny_224" in log and "Epoch [2/2]" in log and "Done." in log
    rows = _history(out / "cswin_tiny_224_training_metrics.csv")
    assert [r["Epoch"] for r in rows] == ["1", "2"] and len(rows[0]) == 8
    assert (out / "cswin_tiny_224_training_metrics.png").stat().st_size > 0
    ckpt = out / "cswin_tiny_224_checkpoints"
    assert {"epoch_1.pt", "epoch_2.pt", "meta.json", "best_weights.pth"} <= set(os.listdir(ckpt))
    model = build_model("cswin_tiny_224", device="cpu", img_size=64)
    load_state_dict_strict(model, load_state_dict_file(
        str(out / "cswin_tiny_224_final_weights.pth")))


def test_evaluate_gives_the_history_of_the_best_epoch(trained):
    out, dirs, _ = trained
    ckpt = out / "cswin_tiny_224_checkpoints"
    log = _run(["evaluate", *ARGS, *dirs, "--weights", str(ckpt / "best_weights.pth"),
                "--split", "test"])
    got = dict(zip(("loss", "dice", "iou"), map(float, re.search(
        r"Evaluated 2 images \(split=test\): Loss: (\S+), Dice: (\S+), IoU: (\S+)",
        log).groups())))
    history = torch.load(ckpt / "epoch_2.pt", weights_only=True)["history"]
    best = int(json.loads((ckpt / "meta.json").read_text())["best_epoch"]) - 1
    for k in got:  # printed with 6 decimals
        assert abs(got[k] - history[f"test_{k}"][best]) <= 1e-6, (k, got[k], history)


def test_predict_writes_a_mask_for_each_image(trained, tmp_path):
    out, dirs, _ = trained
    log = _run(["predict", *ARGS, "--image-dir", dirs[1], "--output-dir", str(tmp_path),
                "--weights", str(out / "cswin_tiny_224_checkpoints"), "--save-probs"])
    assert "Loaded checkpoint epoch 2" in log and "Wrote 8 masks" in log
    masks = sorted(p for p in os.listdir(tmp_path) if p.endswith("_mask.png"))
    assert len(masks) == 8
    m = cv2.imread(str(tmp_path / masks[0]), cv2.IMREAD_UNCHANGED)
    assert m.shape == (64, 64) and set(np.unique(m)) <= {0, 255}
    probs = np.load(tmp_path / masks[0].replace("_mask.png", "_probs.npy"))
    assert probs.shape == (64, 64) and ((probs > 0.5) * 255 == m).all()


def test_export_torch_writes_a_strict_state_dict(trained, tmp_path):
    out, _, _ = trained
    path = str(tmp_path / "exported.pth")
    log = _run(["export-torch", "--config", "cswin_tiny_224", "--image-size", "64",
                "--weights", str(out / "cswin_tiny_224_checkpoints"), "--output", path])
    assert "Wrote torch state_dict" in log
    exported = load_state_dict_file(path)
    final = load_state_dict_file(str(out / "cswin_tiny_224_final_weights.pth"))
    assert set(exported) == set(final)
    assert all(torch.equal(exported[k], final[k]) for k in final)


def test_resume_goes_on_along_the_history(trained, tmp_path):
    """Train 1 epoch, then ``--resume --epochs 2``: 'Resumed from epoch 1'
    and the history of the unbroken 2-epoch run (the same seeds, loader
    order and optimizer state), its final weights bit for bit; a fresh run
    into that checkpoint directory clears it."""
    two, dirs, _ = trained
    one = tmp_path / "one"
    _run(["train", *ARGS, *dirs, "--output-dir", str(one), "--epochs", "1", "--no-progress"])
    log = _run(["train", *ARGS, *dirs, "--output-dir", str(one), "--epochs", "2", "--resume",
                "--no-progress"])
    assert "Resumed from epoch 1" in log and "Epoch [1/2]" not in log
    name = "cswin_tiny_224_training_metrics.csv"
    assert _history(one / name) == _history(two / name)
    a, b = (load_state_dict_file(str(d / "cswin_tiny_224_final_weights.pth")) for d in (one, two))
    assert all(torch.equal(a[k], b[k]) for k in a)
    log = _run(["train", *ARGS, *dirs, "--output-dir", str(one), "--epochs", "1",
                "--no-progress", "--no-augment"])
    assert "starting FRESH and clearing them" in log
    assert sorted(os.listdir(one / "cswin_tiny_224_checkpoints")) == [
        "best_weights.pth", "epoch_1.pt", "meta.json"]


def test_list_configs():
    log = _run(["list-configs"])
    assert [line.split(":")[0] for line in log.splitlines()] == sorted(CONFIGS)
    assert "cswin_tiny_224: cswin img=224 bs=2 opt=adamw simam=False classes=1" in log


@pytest.mark.parametrize("argv,why", [
    (["export-serving", "--config", "cswinunet", "--weights", "w", "--output", "o"],
     "export-serving is not ported"),
    (["train", "--pallas"], "--pallas has no meaning"),
    (["train", "--remat", "block"], "--remat is an XLA"),
    (["train", "--scan-stages"], "--scan-stages is an XLA"),
    (["train", "--segmented"], "ROADMAP queue A item 10"),
    (["predict", "--weights", "w.msgpack", "--image-dir", ".", "--output-dir", "."],
     "msgpack and orbax weights convert with the JAX package's export-torch"),
])
def test_what_is_not_ported_is_refused(data, argv, why):
    _, dirs = data
    if argv[0] == "train":
        argv = argv + [*ARGS, *dirs]
    elif argv[0] == "predict":
        argv = argv + ARGS
    with pytest.raises(ValueError if argv[0] == "predict" else SystemExit, match=why):
        cli.main(argv)


def test_the_card_is_the_default_device(data):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, dirs = data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--config", "cswin_tiny_224", "--image-size", "64", *dirs])
