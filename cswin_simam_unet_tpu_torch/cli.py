"""Command line of the port: train, evaluate, predict, export-torch and
list-configs.

Counterpart of ``cswin_simam_unet_tpu/cli.py``::

    python -m cswin_simam_unet_tpu_torch.cli train --config unet \\
        --image-dir data/images --mask-dir data/masks --output-dir runs

trains the reference's UNet (the default config, as in JAX's CLI; every
name of ``list-configs`` works, the UNet and the CSWin-UNet families alike)
from a directory of ``*.jpg`` images and same-named masks, split as
the reference splits them, with on-device augmentation, a checkpoint every
epoch (``--resume`` goes on from the latest), the metrics CSV and plot and
the final weights as a reference-named ``.pth``.  ``evaluate`` and
``predict`` run from such a weights file or a checkpoint directory.
Everything runs on the card (``--device cuda``, the default) unless
``--device cpu`` asks for the plain versions.

``train`` is data-parallel under ``torch.distributed.run``, as JAX's is over
its devices::

    python -m torch.distributed.run --nproc-per-node N -m cswin_simam_unet_tpu_torch.cli train ...

Rank r computes on ``cuda:{local rank % device count}``.  Where the config's
``data_parallel`` is on (every config but ``cswin_simam_2048``) and N
divides the batch, each rank trains on its share of every batch and the
step is the global batch's (``parallel/``); rank 0 alone prints and writes
the checkpoints, the CSV, the plot and the weights.  Otherwise rank 0 says
why, as JAX does, and trains alone exactly as one process would, while the
other ranks stand aside.

``train --segmented`` trains a CSWin config with the segmented step
(``train/segmented.py``), which recomputes segments of the forward in the
backward to bound activation memory; it is on by default where the config
says so (``cswin_simam_2048``, ``cswin_simam_2048_dp``), and
``--no-segmented`` takes the monolithic step.

Not ported: ``export-serving`` (``jax.export`` artifacts are JAX's own; the
port serves in process, ``serving.Server``), ``--remat`` and
``--scan-stages`` (XLA's compile-size devices) and ``--pallas`` (the port
always runs its kernels on the card).  Each exits with an error that says
so.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from glob import glob

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .compat.io import load_state_dict_strict
from .configs import CONFIGS, build_model, get_config
from .data import DataLoader, SegmentationDataSource, train_test_indices
from .data.dataset import decode_resize
from .parallel import batch_sharding, initialize_runtime, make_mesh, rank_device
from .train.checkpoint import CheckpointStore, load_weights, save_weights
from .train.engine import FitConfig, evaluate, fit, make_eval_step, make_optimizer
from .train.reporting import config_banner, plot_metrics, save_metrics_to_csv
from .train.schedule import make_plateau_scheduler

DEFAULT_CONFIG = "unet"  # JAX's default: the reference's own run
NOT_PORTED = {
    "pallas": "--pallas has no meaning here: the port always runs its CUDA kernels on the card",
    "remat": "--remat is an XLA compile-size device of the JAX package; not ported",
    "scan_stages": "--scan-stages is an XLA compile-size device of the JAX package; not ported",
}


def _common(p: argparse.ArgumentParser, weights: bool = True) -> None:
    p.add_argument("--config", default=DEFAULT_CONFIG, choices=sorted(CONFIGS))
    if weights:
        p.add_argument("--weights", required=True,
                       help="a weights file (.pth/.pt/.npz: the port's, the reference's, or "
                            "the JAX package's export-torch) or a checkpoint directory "
                            "(latest epoch)")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: the kernels) or cpu (the plain versions)")


def _not_ported(p: argparse.ArgumentParser) -> None:
    p.add_argument("--pallas", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--remat", default=None, help=argparse.SUPPRESS)
    p.add_argument("--scan-stages", action="store_true", help=argparse.SUPPRESS)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cswin_simam_unet_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train a segmentation model")
    _common(t, weights=False)
    t.add_argument("--image-dir", required=True)
    t.add_argument("--mask-dir", required=True)
    t.add_argument("--output-dir", default=".")
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--seed", type=int, default=None)
    t.add_argument("--no-augment", action="store_true")
    t.add_argument("--resume", action="store_true",
                   help="go on from the latest checkpoint, if there is one")
    t.add_argument("--init-weights", default=None,
                   help="start from saved weights: a .pth/.pt/.npz state dict or a "
                        "checkpoint directory")
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--bf16", action="store_true", help="bfloat16 compute dtype")
    t.add_argument("--tensorboard-dir", default=None)
    t.add_argument("--checkpoint-every", type=int, default=1,
                   help="checkpoint period in epochs (0: the last epoch only)")
    t.add_argument("--grad-accum", type=int, default=None,
                   help="micro-batches per optimizer step (default: the config's)")
    t.add_argument("--no-progress", action="store_true",
                   help="no live in-epoch progress line")
    t.add_argument("--log-every", type=int, default=0,
                   help="also print a metrics line every N batches (0: off)")
    t.add_argument("--cache-decoded", action="store_true",
                   help="keep the decoded samples in host memory after their first load")
    t.add_argument("--segmented", action=argparse.BooleanOptionalAction, default=None,
                   help="train with the segmented step, which recomputes segments of the "
                        "forward in the backward (bounded activation memory; CSWin "
                        "configs). Default: the config's; --no-segmented forces the "
                        "monolithic step")
    _not_ported(t)

    pr = sub.add_parser("predict", help="segment a directory of images with trained weights")
    _common(pr)
    pr.add_argument("--image-dir", required=True)
    pr.add_argument("--output-dir", required=True)
    pr.add_argument("--batch-size", type=int, default=8)
    pr.add_argument("--threshold", type=float, default=0.5,
                    help="binary probability threshold; several classes take the argmax")
    pr.add_argument("--save-probs", action="store_true",
                    help="also save the float probabilities as .npy")
    pr.add_argument("--bf16", action="store_true")
    _not_ported(pr)

    ev = sub.add_parser("evaluate", help="evaluate trained weights on an image+mask "
                                         "directory, as the in-training eval does")
    _common(ev)
    ev.add_argument("--image-dir", required=True)
    ev.add_argument("--mask-dir", required=True)
    ev.add_argument("--batch-size", type=int, default=None)
    ev.add_argument("--split", choices=["all", "train", "test"], default="all",
                    help="'train'/'test': that side of the training split (the config's "
                         "test_split and --seed)")
    ev.add_argument("--seed", type=int, default=None)
    ev.add_argument("--bf16", action="store_true")
    _not_ported(ev)

    ex = sub.add_parser("export-torch", help="write the weights as a reference-named "
                                             "state dict .pth (strict=True in the reference)")
    ex.add_argument("--config", default=DEFAULT_CONFIG, choices=sorted(CONFIGS))
    ex.add_argument("--weights", required=True)
    ex.add_argument("--output", required=True)
    ex.add_argument("--image-size", type=int, default=None)

    sub.add_parser("export-serving", help="not ported: jax.export artifacts are JAX's own")

    sub.add_parser("list-configs", help="list the configurations")
    return p


def _refuse_not_ported(args) -> None:
    for name, why in NOT_PORTED.items():
        if getattr(args, name, None) not in (None, False):
            raise SystemExit(f"error: {why}")


def _config(args, **extra):
    overrides = dict(extra)
    if getattr(args, "image_size", None) is not None:
        overrides["image_size"] = args.image_size
    if getattr(args, "seed", None) is not None:
        overrides["seed"] = args.seed
    if getattr(args, "bf16", False):
        overrides["model_dtype"] = "bfloat16"
    return get_config(args.config, **overrides)


def _warn_intensity_masks(source, cfg) -> None:
    """Class-id masks expected: say so loudly where the first mask looks
    like intensities (0/255), which the step would clip into range."""
    _, mask0 = source.load(0)
    n = cfg.model.num_classes
    if int(mask0.max()) >= n:
        print(f"WARNING: mask values reach {int(mask0.max())} but config '{cfg.name}' "
              f"expects class ids < {n}; labels will be clipped. Multiclass masks must store "
              f"class ids (0..{n - 1}), not intensities.")


def load_weights_into(model: torch.nn.Module, weights: str) -> str:
    """Load a weights file or a checkpoint directory (latest epoch) into
    ``model`` strictly; returns what was loaded, for the log."""
    if os.path.isdir(weights):
        state, epoch = CheckpointStore(weights).restore_weights()
        load_state_dict_strict(model, state, source=weights)
        return f"checkpoint epoch {epoch} from {weights}"
    load_weights(weights, model)
    return f"weights from {weights}"


def run_train(args) -> int:
    owns_group = not dist.is_initialized()
    try:
        return _train(args)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args) -> int:
    extra = {}
    if args.epochs is not None:
        extra["num_epochs"] = args.epochs
    if args.lr is not None:
        extra["learning_rate"] = args.lr
    if args.grad_accum is not None:
        extra["grad_accum"] = args.grad_accum
    if args.batch_size is not None:
        extra["batch_size"] = args.batch_size
    if args.no_augment:
        extra["augment"] = None
    cfg = _config(args, **extra)
    run, n_classes = cfg.train, cfg.model.num_classes
    device = rank_device(args.device)  # cuda: this rank's card
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank, world = initialize_runtime(device=device)
    say = print if rank == 0 else (lambda *a, **k: None)

    # data parallelism as JAX's CLI decides it: the batch split over the
    # ranks where it divides, else one rank trains as a single process would
    mesh = None
    if world > 1:
        if run.data_parallel and run.batch_size % world == 0:
            mesh = make_mesh(device=device)
        else:
            if run.data_parallel:
                say(f"data_parallel requested but batch_size {run.batch_size} is not "
                    f"divisible by {world} devices; training single-device")
            else:
                say(f"data_parallel is off for config '{cfg.name}'; training single-device")
            if rank > 0:
                return 0
    # class-id masks are resampled by nearest neighbour, on the host and in
    # the augmentation; binary masks keep the reference's bilinear path
    multiclass = n_classes > 1
    augment = run.augment
    if multiclass and augment is not None:
        augment = dataclasses.replace(augment, mask_nearest=True)
    size = (cfg.image_size, cfg.image_size)
    source = SegmentationDataSource(args.image_dir, args.mask_dir, size,
                                    mask_nearest=multiclass)
    if multiclass and rank == 0:
        _warn_intensity_masks(source, cfg)
    train_idx, test_idx = train_test_indices(len(source), run.test_split, run.seed)
    train_loader = DataLoader(
        source, train_idx, run.batch_size, shuffle=True, num_workers=run.num_workers,
        seed=run.seed, cache_decoded=args.cache_decoded,
        sharding=batch_sharding(mesh, grad_accum=run.grad_accum) if mesh else None)
    test_loader = DataLoader(source, test_idx, run.batch_size, shuffle=False,
                             num_workers=max(1, run.num_workers // 2),
                             cache_decoded=args.cache_decoded,
                             sharding=batch_sharding(mesh) if mesh else None)

    segmented = run.segmented if args.segmented is None else args.segmented
    model = build_model(cfg.model, device=device, seed=run.seed)
    opt = make_optimizer(run.optimizer, run.learning_rate, run.weight_decay,
                         model.parameters())
    say(config_banner({
        "config": cfg.name,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "mesh": f"{mesh.shape} ({world} ranks)" if mesh else "single-device",
        "dataset": f"{len(source)} images ({len(train_idx)} train / {len(test_idx)} test)",
        "image_size": cfg.image_size,
        "batch_size": run.batch_size,
        "optimizer": run.optimizer,
        "learning_rate": run.learning_rate,
        "weight_decay": run.weight_decay,
        "epochs": run.num_epochs,
        "augment": augment,
        "dtype": cfg.model.dtype,
        "step": f"segmented (depth split {run.seg_depth_split})" if segmented else "monolithic",
        "params": sum(p.numel() for p in model.parameters()),
    }))

    ckpt_dir = args.checkpoint_dir or run.checkpoint_dir or os.path.join(
        args.output_dir, f"{run.output_prefix}_checkpoints")
    store = CheckpointStore(ckpt_dir)
    fit_cfg = FitConfig(
        num_epochs=run.num_epochs, n_classes=n_classes, augment=augment,
        plateau_factor=run.plateau_factor, plateau_patience=run.plateau_patience,
        plateau_min_lr=run.plateau_min_lr, seed=run.seed, checkpoint_manager=store,
        checkpoint_every=args.checkpoint_every, grad_accum=run.grad_accum,
        segmented=segmented, seg_depth_split=run.seg_depth_split,
        progress=not args.no_progress, log_every=args.log_every,
        tensorboard_dir=args.tensorboard_dir)
    if args.init_weights:
        say(f"Initialised from {load_weights_into(model, args.init_weights)}")

    scheduler = make_plateau_scheduler(opt, run.plateau_factor, run.plateau_patience,
                                       run.plateau_min_lr)
    history, start_epoch, global_step = None, 0, 0
    latest = store.latest_epoch()
    if mesh is not None:  # every rank has read the store before rank 0 may clear it
        mesh.barrier()
    if args.resume and latest is not None:
        sched_state, history, start_epoch, global_step = store.restore(model, opt)
        if sched_state is not None:
            scheduler.load_state_dict(sched_state)
        say(f"Resumed from epoch {start_epoch}")
    elif latest is not None:
        say(f"warning: {ckpt_dir} holds checkpoints from a previous run (latest epoch "
            f"{latest}); starting FRESH and clearing them - pass --resume to "
            f"continue that run instead")
        if rank == 0:
            store.reset()

    history, _ = fit(model, opt, train_loader, test_loader, fit_cfg, history=history,
                     scheduler=scheduler, start_epoch=start_epoch, global_step=global_step,
                     mesh=mesh)

    if rank > 0:  # rank 0 writes the outputs; no rank leaves before they are written
        mesh.barrier()
        return 0
    os.makedirs(args.output_dir, exist_ok=True)
    prefix = os.path.join(args.output_dir, run.output_prefix)
    save_metrics_to_csv(history, f"{prefix}_training_metrics.csv")
    try:
        plot_metrics(history, f"{prefix}_training_metrics.png", title=cfg.name)
        plot = f"{prefix}_training_metrics.png, "
    except ImportError:
        plot = ""
        print(f"matplotlib is not installed: {prefix}_training_metrics.png was not written")
    save_weights(f"{prefix}_final_weights.pth", model)
    best_epoch, best_dice = store.best_epoch()
    best = store.best_weights_path()
    print(f"Done. Best test Dice {best_dice:.4f} at epoch {best_epoch}"
          f"{f' (weights: {best})' if best else ''}. Artifacts: "
          f"{prefix}_training_metrics.csv, {plot}{prefix}_final_weights.pth, "
          f"checkpoints in {ckpt_dir}")
    store.close()
    if mesh is not None:
        mesh.barrier()
    return 0


def _write_png(path: str, mask_u8: np.ndarray) -> None:
    try:
        import cv2
        if not cv2.imwrite(path, mask_u8):  # False instead of raising
            raise IOError(f"cv2.imwrite failed for {path}")
    except ImportError:
        from PIL import Image
        Image.fromarray(mask_u8).save(path)


def run_predict(args) -> int:
    """uint8 mask PNGs of a directory of ``*.jpg``: the probabilities of an
    eval forward, thresholded (one class) or their argmax (several)."""
    from .serving import make_serving_fn

    cfg = _config(args)
    size, n_classes = cfg.image_size, cfg.model.num_classes
    model = build_model(cfg.model, device=resolve_device(args.device))
    print(f"Loaded {load_weights_into(model, args.weights)}")
    serve = make_serving_fn(model)
    paths = sorted(glob(os.path.join(args.image_dir, "*.jpg")))
    if not paths:
        raise ValueError(f"no images found in directory: {args.image_dir}")
    os.makedirs(args.output_dir, exist_ok=True)
    n_done = 0
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i:i + args.batch_size]
        images = []
        for p in chunk:
            with open(p, "rb") as f:
                arr = decode_resize(f.read(), (size, size))
            if arr is None:
                raise ValueError(f"undecodable image: {p}")
            images.append(arr)
        probs = serve(torch.from_numpy(np.stack(images))).float()
        if n_classes == 1:
            masks = ((probs[..., 0] > args.threshold).to(torch.uint8) * 255).cpu().numpy()
        else:
            masks = probs.argmax(-1).to(torch.uint8).cpu().numpy()
        probs = probs.cpu().numpy()
        for p, m, q in zip(chunk, masks, probs):
            base = os.path.splitext(os.path.basename(p))[0]
            _write_png(os.path.join(args.output_dir, f"{base}_mask.png"), m)
            if args.save_probs:
                np.save(os.path.join(args.output_dir, f"{base}_probs.npy"),
                        q[..., 0] if n_classes == 1 else q)
            n_done += 1
    print(f"Wrote {n_done} masks to {args.output_dir}")
    return 0


def run_evaluate(args) -> int:
    """Scores saved weights as the in-training eval does (the eval step,
    a uniform mean over batches)."""
    cfg = _config(args, **({} if args.batch_size is None else {"batch_size": args.batch_size}))
    run, n_classes = cfg.train, cfg.model.num_classes
    device = resolve_device(args.device)
    multiclass = n_classes > 1
    source = SegmentationDataSource(args.image_dir, args.mask_dir,
                                    (cfg.image_size, cfg.image_size), mask_nearest=multiclass)
    if multiclass:
        _warn_intensity_masks(source, cfg)
    if args.split == "all":
        idx = list(range(len(source)))
    else:
        train_idx, test_idx = train_test_indices(len(source), run.test_split, run.seed)
        idx = train_idx if args.split == "train" else test_idx
    loader = DataLoader(source, idx, run.batch_size, shuffle=False,
                        num_workers=max(1, run.num_workers // 2))
    model = build_model(cfg.model, device=device)
    print(f"Loaded {load_weights_into(model, args.weights)}")
    metrics = evaluate(make_eval_step(model, n_classes), loader, device)
    print(f"Evaluated {len(idx)} images (split={args.split}): Loss: {metrics['loss']:.6f}, "
          f"Dice: {metrics['dice']:.6f}, IoU: {metrics['iou']:.6f}")
    return 0


def run_export_torch(args) -> int:
    """The weights as a reference-named state dict ``.pth``: the port's
    names are the reference's, so this checks them against ``--config``
    (strictly, on the CPU) and writes them."""
    cfg = _config(args)
    model = build_model(cfg.model, device="cpu")
    load_weights_into(model, args.weights)
    save_weights(args.output, model)
    print(f"Wrote torch state_dict ({len(model.state_dict())} tensors) to {args.output}")
    return 0


def main(argv=None) -> int:
    parser = build_argparser()
    args, unknown = parser.parse_known_args(argv)
    if unknown and args.command != "export-serving":
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    _refuse_not_ported(args)
    if args.command == "export-serving":
        raise SystemExit("error: export-serving is not ported, by design: jax.export StableHLO "
                         "artifacts are the JAX package's own; the port serves in process "
                         "(cswin_simam_unet_tpu_torch.serving.Server)")
    if args.command == "list-configs":
        for name in sorted(CONFIGS):
            m, t = CONFIGS[name], get_config(name).train
            print(f"{name}: {m.family} img={m.img_size} bs={t.batch_size} opt={t.optimizer} "
                  f"simam={m.use_simam} classes={m.num_classes} dtype={m.dtype}")
        return 0
    return {"train": run_train, "predict": run_predict, "evaluate": run_evaluate,
            "export-torch": run_export_torch}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
