#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the exit code is non-zero:

1. environment: torch, CUDA, nvcc, and the card (nvidia-smi);
2. build: the kernels of ``cswin_simam_unet_tpu_torch/csrc`` (one nvcc per
   source, all started together, then one link);
3. each forward kernel (K-A, K-C, K-H1, K-H2) against its plain PyTorch
   version on the card at the serving path's shapes: float32 at batch 2 with
   a tight tolerance, bfloat16 at batch 2 against the plain version in
   float32 on the same bf16 values with a looser one; then its time, the
   plain version's time, the library call's time where one exists and the
   bound, all in bf16 at batch 8.  K-A also with attention dropout at rate
   0.3, mask for mask against the plain version with the same seed, at every
   window geometry of ``cswin_simam_512`` and of ``cswinunet``, each output
   also against its own max|plain|, the float32 call on the CUDA-core body
   and the bf16 one on the tensor-core body (``_build.BODY_LAUNCHES``), and
   timed at rate 0.3 beside rate 0 (library: SDPA with ``dropout_p``), with
   its device time, the CUDA-core body's time in float32 on the same inputs
   and the SFU/ALU floor of its exps and hashes.  K-C (and K-C' in phase 4)
   at each of the three decoder CARAFEs, each output also against its own
   max|plain|, and timed on the device behind a spin kernel at the 512^2
   (batch 8), 2048^2 (batch 1) and ``cswinunet`` (448^2, batch 2, float32)
   decoders;
4. each backward kernel (K-A', K-C', K3, K4, and K3 and K4 without the gate)
   the same way, at the training step's shapes, every output of the kernel
   checked; K-A' with dropout as K-A; the two kernels without the gate at
   ``cswinunet``'s head (448^2, float32, batch 2); K4 with and without the
   gate also at x (45, 77, 64), in runs of 16 rows and strips of 8 columns
   that divide neither side; K3 and K4 (with and without the gate) also
   timed on the device behind a spin kernel, and at the 2048^2 head (batch
   1, bf16), with K4's SFU and ALU floors logged;
4b. the flash-attention family (the tiled K-A / K-A' of windows of up to
   2048 tokens, and the flash fwd, dq and dk/dv kernels of longer ones)
   against their plain versions at every attention geometry of
   ``cswin_simam_1024`` and ``cswin_simam_2048`` (vertical stripes among
   them; the whole-window K-A / K-A' where they still hold the window), at
   rates 0 and 0.3, mask for mask, batch 1, float32 within 1e-4 (scaled by
   max(1, max|plain|) for backward outputs) and bf16 within 2e-2 x max(1,
   max|plain|) per output, and each output also within 1e-4 (float32) and
   2e-2 (bf16) times its own max|plain|; the tiled entry against K-A / K-A' at 256
   tokens; the tiled K-A's L against the windows' log-sum-exp; after each
   check, that the float32 call launched the CUDA-core bodies and the bf16
   call the tensor-core ones; each kernel's time, its plain version's and
   SDPA's at the 2048^2 path's shapes (batch 1, bf16, rates 0 and 0.3,
   the forward's window and flash modes apart), also its device time, the
   CUDA-core body's time on the same inputs in float32 and the SFU/ALU
   floor of the tensor-core body (its exps and dropout hashes at the card's
   SM count and maximum clock);
5. serving: CSWin-SimAM-UNet at 512^2, full width, bf16, kernels on, random
   weights from a seed, served through ``Server`` for requests of batch 1,
   3, 8 and 11 (launch counts reset before and read after; K-A's
   tensor-core body every launch); output checks;
   kernels-on against kernels-off in bf16 (batch 2) and float32 (batch 1);
   the launch counts of one batch-8 request; ms per batch-8 request and
   images/s.  Then ``cswin_simam_2048`` (full width and depth) for requests
   of batch 1 and 2: the launches of each (48 tiled K-A, 2 flash forwards,
   K-C, K-H1, K-H2), output checks, kernels on against off in bf16 (batch
   2, max |dp| <= 5e-2; the forwards on the tensor-core body), ms per
   request and images/s;
6. training, each path driven by ``make_train_step`` (AdamW, lr 1e-4, weight
   decay 1e-4) on one fixed uint8 batch of bright discs: the launch counts
   of one step (counts reset before and read after), 3 warm-up and 10 timed
   steps (ms per step, images/s, peak device memory), a finite loss whose
   mean over the last 3 of 13 steps is below the first, Dice and IoU in
   [0, 1].  The paths: ``cswin_simam_512`` (bf16, batch 8) at drops 0.3, the
   configs' headline; the same at drops 0; ``cswinunet`` (448^2, no SimAM,
   float32, batch 2) at drops 0.3; ``cswin_simam_2048`` (bf16, batch 1) at
   drops 0.3, the long-window path (48 launches each of the tiled K-A, dq
   and dk/dv, 2 each of the flash kernels per step); each step's attention
   kernels by their tensor-core bodies on the bf16 paths and by K-A's
   CUDA-core body on ``cswinunet``, counted apart in
   ``_build.BODY_LAUNCHES``.  Then one batch-2
   step's gradients with kernels on against kernels off from the same
   weights and the same dropout seed, every parameter, in float32 for both
   512^2 and 448^2 configs (the masks are the same, so the gradients must
   agree) and the loss in bf16; and one batch-1 step of ``cswin_simam_2048``
   at full width and depth (1,1,1,1), float32, drops 0.3 with attention
   dropout 0 (the flash path's mask is not the plain path's).  Then the
   multi-class step: ``cswin_simam_512_dp`` (4 classes, bf16, batch 16 on
   one card, class-id disc masks) through the same training run and checks,
   and one batch-2 step's float32 gradients and bf16 loss with kernels on
   against off (the head's F = 4 kernels in a real step).  Then ``fit`` on
   ``cswin_simam_512`` (bf16, drops 0.3, batch 8): 2 epochs over in-memory
   loaders of host uint8 batches (3 training, 2 test), plateau patience 0;
   every training step's launches are a step's, every eval forward's the
   serving forward's (no backward kernel); 7 finite history series, Dice and
   IoU in [0, 1], the learning rates the schedule's rule gives; ms per epoch
   and images/s.  Last, gradient accumulation on ``cswin_simam_512`` in
   float32 at drops 0: ``grad_accum=2`` at batch 4 (equal micro-batches)
   and 3 (ragged) against the full-batch step from the same weights, every
   parameter's gradient within 1e-3 x max|g|, loss, Dice and IoU within
   1e-5 relative, twice a step's launches, and the ms of each step;
7. data, checkpoints and the CLI: which JPEG decoders the machine has (the
   native library, committed or built, each tried in a child process; cv2;
   PIL); augmentation on the card at 512^2 batch 8 and 2048^2 batch 1 with
   TF32 switched on around it (which it must not use): within 1e-5 of
   float64 on the CPU from the same draws, nearest class-id masks exact,
   against the gather oracle, each k and flip forced, the draws'
   frequencies over 65,536 samples within 5 sigma, ms and device ms against
   the flop bound of its two products; the ``cswin_simam_512`` step (batch
   8, bf16, drops 0.3) without and with augmentation, 3 + 10 steps each, the
   same launches; ``DataLoader`` -> ``device_prefetch`` -> ``fit`` for 2
   epochs from the 24 JPEG pairs under ``tests/data/discs`` (an in-memory
   source where no decoder is found), augmented, with a ``CheckpointStore``:
   every step's launches a step's, the loader's images/s, ms per epoch
   checkpointed, then from files and from the same batches in memory
   without checkpoints, the checkpoint's save ms and size; a fresh model and optimizer restore epoch
   1 and train epoch 2 (cuDNN deterministic in this part), every parameter
   within 1e-6 of the unbroken run (far below one AdamW step), the history
   within 1e-5, the schedule's state and learning rate the same; then the CLI as child processes at
   ``cswin_simam_512``: ``train --epochs 2``, ``train --resume --epochs 3``
   ("Resumed from epoch 2"), ``evaluate`` of the best weights on the test
   split within 1e-4 of the history's best epoch, ``predict`` of 24 masks
   where cv2 or PIL can write them;
8. the UNet family, which launches no kernel of the port: ``unet`` (448^2)
   and ``unet_simam_256`` (256^2) at batch 1 on the card against the CPU
   from the same weights (from SEED) and batch with TF32 off: the eval
   logits, one Adam step's loss, Dice and IoU, and the running statistics
   after it, each within 1e-4 x max(1, max|CPU|), and the float32
   gradients' largest gap as a record; in float64 on both sides, every
   gradient of that step within 1e-9 x its own max|g|; the
   full-width steps of ``unet`` (batch 4) with cuDNN's TF32 off and on (and
   the largest logit gap between the two) and of ``unet_simam_256`` (batch
   4), 3 + 10 steps each: ms, device ms, peak memory, no launch; ``Server``
   over ``unet`` at the buckets 1/2/4/8 with TF32 off and on, ms each;
   ``fit`` of ``unet`` from the JPEG pairs, augmented and checkpointed,
   resumed from epoch 1 into a fresh model and optimizer (cuDNN
   deterministic), the parameters and the BatchNorm buffers within 1e-6 of
   the unbroken run; the CLI as child processes at ``unet``: ``train
   --epochs 2``, ``evaluate`` (against the history), ``predict`` and
   ``export-torch``, whose ``.pth`` loads strictly into a fresh UNet.

The last two lines are the kernel table as JSON and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
port next to this file, it exits non-zero and prints no result.  Each phase
header carries the seconds since the start; a run still going after
``DEADLINE_S`` prints every thread's traceback and exits non-zero, so a hang
names its line instead of running into an outside time limit.
"""

from __future__ import annotations

import copy
import dataclasses
import faulthandler
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

IMG = 512
IMG448 = 448                        # cswinunet
IMG2048 = 2048                      # cswin_simam_2048
SEED = 0
DROP = 0.3                          # the configs' drop / attention-drop / drop-path
DROP_SEED = 2 ** 31 + 12345         # attention-dropout seed of the kernel checks
TIME_BATCH = 8                      # kernels timed at the served bucket
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,   # dense bf16 tensor cores
              "float32": 67e12}     # float32 outside the tensor cores
TOL_F32 = 1e-4                      # max |kernel - plain|, float32 inputs
TOL_BF16 = 2e-2                     # x max(1, max|plain|), bf16 inputs
# the flash family, every output also against its own scale: error / max|plain|
# within TOL_F32 (float32) and TOL_BF16 (bf16), with no floor at 1, since
# dq, dk and dv stay far below 1 at the path's input scales
# backward kernels, float32: x max(1, max|plain|) of each output, since their
# reductions over the batch (dw, A, B, dW, db) reach O(100)
TOL_BWD_F32 = 1e-4
TOL_STATS = 1e-4                    # x (1 + |plain|), K-H1 pooled moments
TOL_MODEL_BF16 = 5e-2               # probabilities, kernels on vs off, bf16
TOL_MODEL_F32 = 1e-3                # probabilities, kernels on vs off, f32
TOL_GRAD_F32 = 1e-3                 # x max|g| per parameter, kernels on vs off, f32
TOL_LOSS_BF16 = 1e-2                # training loss, kernels on vs off, bf16
SFU_PER_CLOCK = 16                  # exp2 per SM and clock (sm_90)
INT_PER_CLOCK = 64                  # 32-bit integer operations per SM and clock (sm_90)
HASH_OPS = 10                       # integer operations of one keep bit (fmix32 and its counter)
TRAIN_WARMUP, TRAIN_STEPS, CHECK_BATCH = 3, 10, 2
DEADLINE_S = 1100                   # the whole run takes about 200 s on the H100
LOSS_TAIL = 3                       # the mean of the last 3 losses is below the first
TOL_ACCUM = 1e-5                    # relative, loss / Dice / IoU, grad_accum 2 vs the full batch
ACCUM_STEPS = 3                     # timed steps of each gradient-accumulation run


def log(*args) -> None:
    print(*args, flush=True)


def phase(title: str) -> None:
    log(f"== {title}  [{time.perf_counter() - T_START:.1f} s]")


def run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of fn() without the host's dispatch time: the calls
    are queued behind a spin kernel (``torch.cuda._sleep``, about 25 ms)
    that holds the stream until the host has issued all of them, so the
    events time them back to back on the device.  time_ms includes the
    host's time where a call costs the host more than its kernels cost the
    device.  fn must not wait for the device."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_clock(torch) -> tuple[int, float]:
    """The card's SM count and maximum SM clock (MHz)."""
    mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"]).splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count, mhz


def add_floor(torch, row) -> None:
    """The SFU/ALU floor of a tensor-core body from its ``exps`` and
    ``hashes`` (computed from assumed rates, not measured): exp2 on the SFU
    (SFU_PER_CLOCK a clock per SM), the hash's fmix32 at about HASH_OPS
    integer operations (INT_PER_CLOCK a clock per SM), at the card's maximum
    SM clock; at rate 0 no hash runs."""
    sms, mhz = sm_clock(torch)
    hz = mhz * 1e6
    row["sfu_ms"] = row["exps"] / (sms * SFU_PER_CLOCK * hz) * 1e3
    row["alu_ms"] = row["hashes"] * HASH_OPS / (sms * INT_PER_CLOCK * hz) * 1e3
    row["floor_ms"] = max(row["sfu_ms"], row["bound_ms"])
    row["floor_ms_drop"] = max(row["sfu_ms"], row["alu_ms"], row["bound_ms"])
    row["floor_clock"] = f"{sms} SMs at {mhz:.0f} MHz"


def floor_text(row) -> str:
    return (f"SFU/ALU floor (computed from assumed rates, not measured) "
            f"{row['floor_ms']:.3f} / {row['floor_ms_drop']:.3f} ms "
            f"({row['exps'] / 1e9:.3f} G exps: {row['sfu_ms']:.3f} ms on {row['floor_clock']}; "
            f"{row['hashes'] / 1e9:.3f} G hashes: {row['alu_ms']:.3f} ms)")


def k4_bytes(x, e, fb, dy, E, F_cls) -> float:
    """Bytes K4 must move in bf16: x, enc, fb and dy read, dx and denc
    written, the (B, E) float32 statistics, w and db."""
    B = x.shape[0]
    return ((2 * x.numel() + 2 * e.numel() + fb.numel() + dy.numel()) * 2
            + 4 * B * E * 4 + E * F_cls * 2 + E * 4)


def head_floor_text(torch, numel, pixels, G, kernel) -> str:
    """The SFU and ALU floors of K3, K4, K-H1, K-H2 or K5 over a flat head
    map of ``numel`` elements (computed from assumed rates, not measured) on
    the SFU (SFU_PER_CLOCK a clock per SM) and in float32 operations (128 a
    clock per SM), at the card's maximum SM clock.  K3 and K-H2: one sigmoid
    per element (exp2 and a reciprocal), about 12 operations an element
    (K-H2 14, with the dot); K4: the same plus the 9*G tap exps and
    reciprocals of each of ``pixels`` pixels, and the SimAM VJP, about 16,
    plus dp and dx, 9 FMAs each; K-H1: 9 exps and a reciprocal per (pixel,
    sub-pixel), and about 15 operations an element (9 FMAs, two roundings,
    the bias, the moments); K5 at one class (bf16): the sigmoid, and 36
    instructions an element, K5 without the gate no SFU work and 6, as its
    SASS' main loop issues them (1147 and 188 per 32 elements), at 128 an
    SM and clock."""
    sms, mhz = sm_clock(torch)
    hz = mhz * 1e6
    sfu_ops = {"K3": 2 * numel, "K-H2": 2 * numel, "K4": 2 * numel + 2 * 9 * G * pixels,
               "K-H1": 10 * G * pixels, "K5": 2 * numel, "K5 no gate": 0}[kernel]
    alu_ops = {"K3": 12 * numel, "K-H2": 14 * numel, "K4": (16 + 18) * numel,
               "K-H1": 15 * numel, "K5": 36 * numel, "K5 no gate": 6 * numel}[kernel]
    sfu = sfu_ops / (sms * SFU_PER_CLOCK * hz) * 1e3
    alu = alu_ops / (sms * 128 * hz) * 1e3
    return (f"{kernel} SFU floor {sfu:.4f} ms, ALU floor {alu:.4f} ms (computed from assumed "
            f"rates, not measured; {sms} SMs at {mhz:.0f} MHz)")


def no_lepe(fn):
    """fn(q, k, v, lepe_kernel, *rest) with the LePE taps set to zero."""
    return lambda q, k, v, w, *rest: fn(q, k, v, w.new_zeros(w.shape), *rest)


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def check_pair(name, torch, kernel_fn, plain_fn, make, batch=2, own=False):
    """Kernel vs plain at float32 and at bf16; returns the float32 and bf16
    errors.  With ``own``, each is also held to its tolerance times the
    output's own max|plain| (no floor at 1), and those two ratios follow."""
    x32 = make(batch, torch.float32)
    ref32 = plain_fn(*x32)
    err32 = max_err(kernel_fn(*x32), ref32)
    x16 = make(batch, torch.bfloat16)
    ref16 = plain_fn(*[t.float() if t.is_floating_point() else t for t in x16])
    err16 = max_err(kernel_fn(*x16), ref16)
    tol16 = TOL_BF16 * max(1.0, float(ref16.abs().max()))
    torch.cuda.synchronize()
    rel = (err32 / float(ref32.abs().max()), err16 / float(ref16.abs().max()))
    log(f"  {name}: f32 max_abs_err {err32:.3e} (tol {TOL_F32:g})  "
        f"bf16 max_abs_err {err16:.3e} (tol {tol16:.3e})"
        + (f"  own scale f32 {rel[0]:.3e} bf16 {rel[1]:.3e} (tol {TOL_F32:g}, {TOL_BF16:g})"
           if own else ""))
    require(err32 <= TOL_F32, f"{name}: float32 error {err32} > {TOL_F32}")
    require(err16 <= tol16, f"{name}: bf16 error {err16} > {tol16}")
    if not own:
        return err32, err16
    require(rel[0] <= TOL_F32 and rel[1] <= TOL_BF16,
            f"{name}: error over the output's own max|plain| {rel}")
    return err32, err16, *rel


def check_outputs(name, torch, kernel_fn, plain_fn, make, batch=2, own=(), ratios=None,
                  own32=False):
    """Backward kernel vs plain at float32 and at bf16, every output; the
    error of each output is taken relative to max(1, max|plain|) of it.
    The outputs listed in ``own`` (indices) are also held in bf16 to
    TOL_BF16 times their own max|plain|, with no floor at 1, and with
    ``own32`` in float32 to TOL_BWD_F32 times it too; every output's
    max|plain| and bf16 error over it are logged.  Returns the largest
    scaled errors (float32, bf16) and the largest absolute one in float32;
    ``ratios`` (a dict), where given, keeps the largest bf16 error over its
    own max|plain| of the ``own`` outputs under "own16" (and with
    ``own32`` the float32 one under "own32")."""
    errs, abs32, tops = [], 0.0, []
    for dtype, tol in ((torch.float32, TOL_BWD_F32), (torch.bfloat16, TOL_BF16)):
        args = make(batch, dtype)
        got = kernel_fn(*args)
        want = plain_fn(*[t.float() if t.is_floating_point() else t for t in args])
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            require(tuple(g.shape) == tuple(w.shape), f"{name}: shape {tuple(g.shape)} "
                    f"!= {tuple(w.shape)}")
            err, top = max_err(g, w), float(w.abs().max())
            if dtype == torch.float32:
                abs32 = max(abs32, err)
                if own32 and i in own:
                    if ratios is not None:
                        ratios["own32"] = max(ratios.get("own32", 0.0),
                                              err / max(top, 1e-30))
                    require(err <= TOL_BWD_F32 * top, f"{name}: float32 output {i} error "
                            f"{err} > {TOL_BWD_F32} x max|plain| {top}")
            else:
                tops.append(f"{top:.3g} ({err / max(top, 1e-30):.2e})")
                if ratios is not None and i in own:
                    ratios["own16"] = max(ratios.get("own16", 0.0), err / max(top, 1e-30))
                require(i not in own or err <= TOL_BF16 * top,
                        f"{name}: bf16 output {i} error {err} > {TOL_BF16} x max|plain| {top}")
            worst = max(worst, err / max(1.0, top))
        torch.cuda.synchronize()
        require(worst <= tol, f"{name}: {dtype} scaled error {worst} > {tol}")
        errs.append(worst)
    log(f"  {name}: f32 scaled err {errs[0]:.3e} (tol {TOL_BWD_F32:g})  "
        f"bf16 scaled err {errs[1]:.3e} (tol {TOL_BF16:g})  f32 max abs err {abs32:.3e}; "
        f"bf16 max|plain| (err over it) per output: {', '.join(tops)}"
        + (f"; own scale held for outputs {list(own)}" if own else "")
        + (" in float32 too" if own and own32 else ""))
    return errs[0], errs[1], abs32


def attention_geometries(model) -> dict:
    """{(resolution, channels, heads, hsp, wsp): branches} of a model."""
    from cswin_simam_unet_tpu_torch.models.layers import LePEAttention
    geoms: dict = {}
    for mod in model.modules():
        if isinstance(mod, LePEAttention):
            key = (mod.resolution, mod.get_v.weight.shape[0], mod.num_heads, mod.hsp, mod.wsp)
            geoms[key] = geoms.get(key, 0) + 1
    return geoms


def disc_arrays(img: int, batch: int, n_classes: int = 1, seed: int = SEED + 1):
    """A fixed uint8 batch of discs on noise and their masks, on the host:
    binary masks 255 in the discs; with several classes each image's three
    discs are classes 1-3 (ids on background 0), each class its own
    brightness."""
    import numpy as np
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:img, :img]
    images = rs.randint(0, 160, (batch, img, img, 3)).astype("uint8")
    masks = np.zeros((batch, img, img, 1), "uint8")
    for i in range(batch):  # a learnable batch
        for j in range(3):
            cy, cx = rs.randint(img // 8, img - img // 8, size=2)
            rad = rs.randint(20, 60)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < rad * rad
            cls = 1 + (i + j) % 3 if n_classes > 1 else 1
            images[i][disc] = 255 - 40 * (cls - 1)
            masks[i, disc, 0] = cls if n_classes > 1 else 255
    return images, masks


def disc_batch(torch, img: int, batch: int, dev, n_classes: int = 1):
    """:func:`disc_arrays` on ``dev``."""
    images, masks = disc_arrays(img, batch, n_classes)
    return torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev)


def train_phase(torch, engine, _build, label, model, tcfg, want_step, dev,
                want_bodies, augment=None, img=None, device_time=False) -> dict:
    """Train a copy of ``model`` with ``make_train_step`` on one fixed batch
    of ``img``^2 (the model's own size by default): the launch counts of one
    step (reset before, read after) must be ``want_step``, and the attention
    kernels' body launches ``want_bodies``; then 3 warm-up and 10 timed
    steps.  Returns the step's ms, images/s, peak memory, launches and the
    losses, and with ``device_time`` the step's device ms (``device_ms``).
    With ``augment`` each step augments the batch on the card (new draws
    each step), and the loss need not fall."""
    img = img or model.img_size
    phase(f"training {label}, {img}^2, {model.dtype}: {tcfg}")
    images_d, masks_d = disc_batch(torch, img, tcfg.batch_size, dev, model.num_classes)
    trained = copy.deepcopy(model)
    opt = engine.make_optimizer(tcfg.optimizer, tcfg.learning_rate, tcfg.weight_decay,
                                trained.parameters())
    step = engine.make_train_step(trained, opt, model.num_classes, grad_accum=tcfg.grad_accum,
                                  seed=SEED, augment=augment)
    torch.cuda.synchronize()
    _build.reset_launches()
    history = [step(images_d, masks_d)]
    torch.cuda.synchronize()
    one_step = {k: n for k, n in _build.LAUNCHES.items() if n}
    bodies = {k: n for k, n in _build.BODY_LAUNCHES.items() if n}
    log(f"launches of one training step: {one_step}; attention bodies: {bodies}")
    require(one_step == want_step, f"{label}: step launches {one_step} != {want_step}")
    require(bodies == want_bodies, f"{label}: step body launches {bodies} != {want_bodies}")
    for _ in range(TRAIN_WARMUP - 1):
        history.append(step(images_d, masks_d))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        history.append(step(images_d, masks_d))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    timed = {k: n for k, n in _build.LAUNCHES.items() if n}
    timed_bodies = {k: n for k, n in _build.BODY_LAUNCHES.items() if n}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    require(timed == {k: TRAIN_STEPS * n for k, n in want_step.items()},
            f"{label}: timed-loop launches {timed}")
    require(timed_bodies == {k: TRAIN_STEPS * n for k, n in want_bodies.items()},
            f"{label}: timed-loop body launches {timed_bodies}")
    hist = [{k: float(v) for k, v in h.items()} for h in history]
    for i, h in enumerate(hist):
        log(f"  step {i}: loss {h['loss']:.6f} dice {h['dice']:.4f} iou {h['iou']:.4f}")
        require(math.isfinite(h["loss"]), f"{label} step {i}: non-finite loss")
        require(0.0 <= h["dice"] <= 1.0 and 0.0 <= h["iou"] <= 1.0,
                f"{label} step {i}: dice/iou outside [0, 1]")
    tail = sum(h["loss"] for h in hist[-LOSS_TAIL:]) / LOSS_TAIL
    require(augment is not None or tail < hist[0]["loss"],
            f"{label}: the loss did not fall on a fixed batch")
    ips = tcfg.batch_size * 1e3 / step_ms
    extra = {}
    if device_time:
        extra["device_step_ms"] = device_ms(torch, lambda: step(images_d, masks_d))
    log(f"training step {label}, batch {tcfg.batch_size}: {step_ms:.2f} ms, {ips:.1f} "
        f"images/s (mean of {TRAIN_STEPS}, host clock after synchronize, {TRAIN_WARMUP} "
        f"warm-up steps); peak device memory {peak_gib:.2f} GiB; loss {hist[0]['loss']:.4f} "
        f"-> mean of last {LOSS_TAIL} {tail:.4f}"
        + (f"; device {extra['device_step_ms']:.3f} ms a step (behind a spin kernel)"
           if device_time else ""))
    del trained, opt, step
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, images_per_s=ips, peak_gib=peak_gib, launches=one_step,
                bodies=bodies, first_loss=hist[0]["loss"], last3_mean_loss=tail,
                batch=tcfg.batch_size, img=img, **extra)


def check_outputs_by_kernel(name, torch, kernel_fn, plain_fn, make, groups, scaled32,
                            batch=1):
    """Kernel vs plain at float32 and at bf16, every output, each output
    credited to the kernel (``groups``: kernel -> output indices) that
    writes it.  bf16 errors are scaled by max(1, max|plain|) of the output;
    float32 ones too where ``scaled32`` (backward outputs: dw sums over a
    branch), else absolute.  Every output is also held to the same
    tolerance times its own max|plain|, with no floor at 1.  Returns
    {kernel: [f32 err, bf16 err, f32 err / max|plain|, bf16 err / max|plain|]}."""
    res = {g: [0.0, 0.0, 0.0, 0.0] for g in groups}
    for col, (dtype, tol) in enumerate(((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16))):
        args = make(batch, dtype)
        got = kernel_fn(*args)
        want = plain_fn(*[t.float() if t.is_floating_point() else t for t in args])
        for g, idx in groups.items():
            for i in idx:
                require(got[i].numel() == want[i].numel(),
                        f"{name}: output {i} has {got[i].numel()} elements, plain "
                        f"{want[i].numel()}")
                raw = max_err(got[i].reshape(want[i].shape), want[i])
                top = float(want[i].abs().max())
                require(top > 0.0, f"{name}: {g} output {i}: the plain version is all zero")
                err = raw / max(1.0, top) if col == 1 or scaled32 else raw
                rel = raw / top
                require(err <= tol, f"{name}: {g} output {i} {dtype} error {err} > {tol}")
                require(rel <= tol, f"{name}: {g} output {i} {dtype} error {raw} > {tol} x "
                                    f"max|plain| {top}")
                res[g][col] = max(res[g][col], err)
                res[g][2 + col] = max(res[g][2 + col], rel)
        torch.cuda.synchronize()
    log(f"  {name}: " + "  ".join(f"{g} f32 {e[0]:.3e} bf16 {e[1]:.3e} (own scale f32 "
                                   f"{e[2]:.3e} bf16 {e[3]:.3e})" for g, e in res.items())
        + f" (tol f32 {TOL_F32:g}{' scaled' if scaled32 else ''}, bf16 {TOL_BF16:g} scaled;"
        f" own scale {TOL_F32:g}, {TOL_BF16:g})")
    return res


def long_window_phase(torch, F, dev, randn, geoms, path_geoms) -> dict:
    """Phase 4b: the flash family against its plain versions at every
    attention geometry of ``cswin_simam_1024`` and ``cswin_simam_2048``
    (``geoms``; the whole-window K-A / K-A' where they still hold the
    window), at rates 0 and 0.3, mask for mask; the tiled entry against the
    whole-window kernels at 256 tokens; then each kernel's time at the
    2048^2 path's shapes (batch 1, bf16; ``path_geoms``: launches per
    forward), its plain version's, SDPA's on the same windows and the
    bound.  Returns the three kernel-table rows."""
    from cswin_simam_unet_tpu_torch import _build
    from cswin_simam_unet_tpu_torch.ops import attention, flash_attention as fa
    from cswin_simam_unet_tpu_torch.ops import stripe_attention as sa
    rows = {k: dict(ms=0.0, ms_drop=0.0, plain_ms=0.0, plain_ms_drop=0.0, library_ms=0.0,
                    library_ms_drop=0.0, bytes=0.0, flops=0.0, err32=0.0, err16=0.0,
                    err32_drop=0.0, err16_drop=0.0, rel32=0.0, rel16=0.0, rel32_drop=0.0,
                    rel16_drop=0.0, ms_window=0.0, ms_flash=0.0,
                    bound_ms_window=0.0, bound_ms_flash=0.0)
            for k in ("fwd", "dq", "dkv")}
    for k in rows:  # the tensor-core bodies: device time, the CUDA-core body, floors
        rows[k].update(device_ms=0.0, device_ms_drop=0.0, ms_fma_f32=0.0, ms_fma_f32_drop=0.0,
                       exps=0.0, hashes=0.0)
    rows["fwd"].update(device_ms_window=0.0, device_ms_flash=0.0, bands_window_ms=0.0,
                       bands_flash_ms=0.0)

    def require_bodies(name, mode, entries, also=None):
        """One float32 and one bf16 call of each entry ran since the counts
        were reset: the CUDA-core body took the float32 call, the
        tensor-core body the bf16 one; ``also``: other body launches."""
        got = {k: n for k, n in _build.BODY_LAUNCHES.items() if n}
        want = {f"{e}:{mode}:{b}": 1 for e in entries for b in ("mma", "fma")}
        want.update(also or {})
        require(got == want, f"{name}: flash body launches {got} != {want}")

    bwd_entries = (fa.DQ_KERNEL, fa.DKV_KERNEL)

    def fold(res, rate):
        sfx = "_drop" if rate else ""
        for g, errs in res.items():
            for key, e in zip(("err32", "err16", "rel32", "rel16"), errs):
                rows[g][key + sfx] = max(rows[g][key + sfx], e)

    def make_tokens(L, Cb, grad):
        def make(B, dtype):
            qkv = randn(B, L, 6 * Cb, scale=0.5, dtype=dtype)  # branch slices
            out = [qkv[..., :Cb], qkv[..., 2 * Cb:3 * Cb], qkv[..., 4 * Cb:5 * Cb],
                   randn(3, 3, 1, Cb, scale=1 / 3, dtype=dtype)]
            return out + [randn(B, L, Cb, dtype=dtype)] if grad else out
        return make

    for (reso, Cb, heads, hsp, wsp) in sorted(geoms):
        L, N, D = reso * reso, hsp * wsp, Cb // heads
        kw = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads)
        for rate in (0.0, DROP):
            kwr = dict(kw, attn_drop=rate, seed=DROP_SEED)
            name = f"reso {reso} window {hsp}x{wsp} ({N} tokens) Cb {Cb} heads {heads} rate {rate}"
            if sa.whole_window(N, D):
                check_pair("K-A " + name, torch,
                           lambda q, k, v, w, kw=kwr: sa.attention_fwd(q, k, v, w, **kw),
                           lambda q, k, v, w, kw=kwr: attention.stripe_attention(q, k, v, w,
                                                                                 **kw),
                           make_tokens(L, Cb, False), batch=1)
                check_outputs("K-A' " + name, torch,
                              lambda q, k, v, w, g, kw=kwr: sa.attention_bwd(
                                  q, k, v, w, g, **kw,
                                  lse=sa.attention_fwd(q, k, v, w, **kw, with_lse=True)[1]),
                              lambda q, k, v, w, g, kw=kwr:
                              attention.stripe_attention_bwd_reference(q, k, v, w, g, **kw),
                              make_tokens(L, Cb, True), batch=1)
            elif N <= fa.FLASH_MIN_TOKENS:
                _build.reset_launches()
                fold(check_outputs_by_kernel(  # out, and L against the windows' log-sum-exp
                    "tiled K-A " + name, torch,
                    lambda q, k, v, w, kw=kwr: sa.tiled_fwd(q, k, v, w, **kw),
                    lambda q, k, v, w, kw=kwr, geo=kw: (
                        attention.stripe_attention(q, k, v, w, **kw),
                        attention.stripe_attention_lse(q, k, **geo)),
                    make_tokens(L, Cb, False), {"fwd": [0, 1]}, scaled32=False), rate)
                require_bodies("tiled K-A " + name, "window", (fa.FWD_KERNEL,))
                fold(check_outputs_by_kernel(  # the attention alone (zero LePE taps)
                    "tiled K-A without LePE " + name, torch,
                    no_lepe(lambda q, k, v, w, kw=kwr: sa.tiled_fwd(q, k, v, w, **kw)[:1]),
                    no_lepe(lambda q, k, v, w, kw=kwr: (
                        attention.stripe_attention(q, k, v, w, **kw),)),
                    make_tokens(L, Cb, False), {"fwd": [0]}, scaled32=False), rate)
                _build.reset_launches()
                fold(check_outputs_by_kernel(
                    "tiled K-A' " + name, torch,
                    lambda q, k, v, w, g, kw=kwr: sa.tiled_bwd(
                        q, k, v, w, sa.tiled_fwd(q, k, v, w, **kw)[1], g, **kw),
                    lambda q, k, v, w, g, kw=kwr: attention.stripe_attention_bwd_reference(
                        q, k, v, w, g, **kw),
                    make_tokens(L, Cb, True), {"dq": [0], "dkv": [1, 2, 3]}, scaled32=True),
                    rate)
                require_bodies("tiled K-A' " + name, "window", _build.FLASH_ENTRIES)
                _build.reset_launches()
                fold(check_outputs_by_kernel(  # zero LePE taps: dv is P^T dO alone
                    "tiled K-A' without LePE " + name, torch,
                    no_lepe(lambda q, k, v, w, g, kw=kwr: sa.tiled_bwd(
                        q, k, v, w, sa.tiled_fwd(q, k, v, w, **kw)[1], g, **kw)),
                    no_lepe(lambda q, k, v, w, g, kw=kwr: attention.stripe_attention_bwd_reference(
                        q, k, v, w, g, **kw)),
                    make_tokens(L, Cb, True), {"dq": [0], "dkv": [1, 2, 3]}, scaled32=True),
                    rate)
                require_bodies("tiled K-A' without LePE " + name, "window",
                               _build.FLASH_ENTRIES)
            else:
                flip, Ht, Wt, wht = fa.band_geometry(reso, reso, hsp, wsp)
                require(not flip, "the flash geometries of the configs are global windows")
                geo = dict(H=Ht, W=Wt, hsp=wht, wsp=Wt, num_heads=heads, attn_drop=rate,
                           seed=DROP_SEED)
                ref_kw = dict(heads=heads, attn_drop=rate, seed=DROP_SEED)

                def bands(t, N=N, Cb=Cb):
                    return t.reshape(-1, N, Cb)

                def make_fwd(B, dtype, L=L, Cb=Cb):
                    return [randn(B, L, Cb, scale=0.5, dtype=dtype) for _ in range(3)]

                def make_bwd(B, dtype, L=L, Cb=Cb, ref_kw=ref_kw, bands=bands):
                    q, k, v, g = [randn(B, L, Cb, scale=0.5, dtype=dtype) for _ in range(4)]
                    o, lse = fa.flash_attention_reference(
                        *(bands(t.float()) for t in (q, k, v)), **ref_kw)
                    return q, k, v, g, o.to(dtype).reshape(q.shape), lse

                _build.reset_launches()
                fold(check_outputs_by_kernel(
                    "flash fwd " + name, torch,
                    lambda q, k, v, geo=geo: fa.kernel_fwd(q, k, v, None, **geo, mode="flash"),
                    lambda q, k, v, ref_kw=ref_kw, bands=bands: fa.flash_attention_reference(
                        bands(q), bands(k), bands(v), **ref_kw),
                    make_fwd, {"fwd": [0, 1]}, scaled32=False), rate)
                require_bodies("flash fwd " + name, "flash", (fa.FWD_KERNEL,))
                _build.reset_launches()
                fold(check_outputs_by_kernel(
                    "flash dq, dkv " + name, torch,
                    lambda q, k, v, g, o, lse, geo=geo, bands=bands: fa.kernel_bwd(
                        q, k, v, None, lse, g, **geo, mode="flash",
                        delta=fa.flash_delta(bands(o), bands(g), geo["num_heads"]))[:3],
                    lambda q, k, v, g, o, lse, ref_kw=ref_kw, bands=bands:
                    fa.flash_attention_bwd_reference(*(bands(t) for t in (q, k, v, o)), lse,
                                                     bands(g), **ref_kw),
                    make_bwd, {"dq": [0], "dkv": [1, 2]}, scaled32=True), rate)
                require_bodies("flash dq, dkv " + name, "flash", bwd_entries)

    # the tiled entry against the whole-window kernels where both run: the
    # flagship's stage-4 global window (256 tokens), dropout 0.3
    kwc = dict(H=16, W=16, hsp=16, wsp=16, num_heads=16, attn_drop=DROP, seed=DROP_SEED)
    fold(check_outputs_by_kernel(
        "tiled vs whole-window K-A, 16x16 window, Cb 512", torch,
        lambda q, k, v, w: sa.tiled_fwd(q, k, v, w, **kwc)[:1],
        lambda q, k, v, w: (sa.attention_fwd(q, k, v, w, **kwc),),
        make_tokens(256, 512, False), {"fwd": [0]}, scaled32=False, batch=2), DROP)
    _build.reset_launches()
    fold(check_outputs_by_kernel(
        "tiled vs whole-window K-A', 16x16 window, Cb 512", torch,
        lambda q, k, v, w, g: sa.tiled_bwd(q, k, v, w, sa.tiled_fwd(q, k, v, w, **kwc)[1], g,
                                           **kwc),
        lambda q, k, v, w, g: sa.attention_bwd(
            q, k, v, w, g, **kwc, lse=sa.attention_fwd(q, k, v, w, **kwc, with_lse=True)[1]),
        make_tokens(256, 512, True), {"dq": [0], "dkv": [1, 2, 3]}, scaled32=True, batch=2),
        DROP)
    # the whole-window pair ran on the float32 inputs of both columns
    require_bodies("tiled vs whole-window K-A'", "window", _build.FLASH_ENTRIES,
                   {f"{sa.KERNEL}:fma": 2, f"{sa.BWD_KERNEL}:fma": 2})

    # times at the 2048^2 path's shapes: batch 1, bf16; per forward or step
    for (reso, Cb, heads, hsp, wsp), count in sorted(path_geoms.items()):
        L, N, D = reso * reso, hsp * wsp, Cb // heads
        kw = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads)
        mode = "window" if N <= fa.FLASH_MIN_TOKENS else "flash"
        q, k, v, w, g = make_tokens(L, Cb, True)(1, torch.bfloat16)
        qh, kh, vh = (attention.window_heads(t, hsp, wsp, reso, reso, heads).contiguous()
                      for t in (q, k, v))
        gh = attention.window_heads(g, hsp, wsp, reso, reso, heads).contiguous()
        tiled = mode == "window"
        # the CUDA-core body at the same shapes: it serves float32
        q32, k32, v32, w32, g32 = (t.float() for t in (q, k, v, w, g))
        for rate in (0.0, DROP):
            kwr = dict(kw, attn_drop=rate, seed=DROP_SEED)
            sfx = "_drop" if rate else ""
            lepe = w if tiled else None
            out, lse = fa.kernel_fwd(q, k, v, lepe, **kwr, mode=mode)
            delta = None if tiled else fa.flash_delta(out, g, heads).reshape(lse.shape)
            dq, delta = fa.kernel_dq(q, k, v, lse, g, **kwr, delta=delta, mode=mode)
            ms = {"fwd": time_ms(torch, lambda: fa.kernel_fwd(q, k, v, lepe, **kwr, mode=mode)),
                  "dq": time_ms(torch, lambda: fa.kernel_dq(
                      q, k, v, lse, g, **kwr, delta=None if tiled else delta, mode=mode)),
                  "dkv": time_ms(torch, lambda: fa.kernel_dkv(q, k, v, lepe, lse, delta, g,
                                                              **kwr, mode=mode))}
            dev_ms = {"fwd": device_ms(torch, lambda: fa.kernel_fwd(q, k, v, lepe, **kwr,
                                                                   mode=mode)),
                      "dq": device_ms(torch, lambda: fa.kernel_dq(
                          q, k, v, lse, g, **kwr, delta=None if tiled else delta, mode=mode)),
                      "dkv": device_ms(torch, lambda: fa.kernel_dkv(q, k, v, lepe, lse, delta,
                                                                    g, **kwr, mode=mode))}
            lepe32 = w32 if tiled else None
            out32, lse32 = fa.kernel_fwd(q32, k32, v32, lepe32, **kwr, mode=mode)
            delta32 = None if tiled else fa.flash_delta(out32, g32, heads).reshape(lse32.shape)
            _, delta32 = fa.kernel_dq(q32, k32, v32, lse32, g32, **kwr, delta=delta32, mode=mode)
            fma = {"fwd": time_ms(torch, lambda: fa.kernel_fwd(q32, k32, v32, lepe32, **kwr,
                                                              mode=mode), iters=3),
                   "dq": time_ms(torch, lambda: fa.kernel_dq(
                       q32, k32, v32, lse32, g32, **kwr, delta=None if tiled else delta32,
                       mode=mode), iters=3),
                   "dkv": time_ms(torch, lambda: fa.kernel_dkv(
                       q32, k32, v32, lepe32, lse32, delta32, g32, **kwr, mode=mode), iters=3)}
            del out32, lse32, delta32
            if tiled:
                plain_f = time_ms(torch, lambda: attention.stripe_attention(q, k, v, w, **kwr),
                                  iters=3)
                plain_b = time_ms(torch, lambda: attention.stripe_attention_bwd_reference(
                    q, k, v, w, g, **kwr), iters=3)
            else:
                rk = dict(heads=heads, attn_drop=rate, seed=DROP_SEED)
                qb, kb, vb, gb, ob = (t.reshape(-1, N, Cb) for t in (q, k, v, g, out))
                plain_f = time_ms(torch, lambda: fa.flash_attention_reference(qb, kb, vb, **rk),
                                  iters=3)
                plain_b = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
                    qb, kb, vb, ob, lse, gb, **rk), iters=3)
            lib_f = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, dropout_p=rate, scale=D ** -0.5))
            qg, kg, vg = (t.detach().requires_grad_() for t in (qh, kh, vh))
            sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate,
                                                      scale=D ** -0.5)
            lib_b = time_ms(torch, lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), gh,
                                                               retain_graph=True))
            del sdpa_out, qg, kg, vg
            for key, plain, lib in (("fwd", plain_f, lib_f), ("dq", plain_b, lib_b),
                                    ("dkv", plain_b, lib_b)):
                rows[key]["ms" + sfx] += count * ms[key]
                rows[key]["plain_ms" + sfx] += count * plain
                rows[key]["library_ms" + sfx] += count * lib
                if not rate:
                    rows[key]["ms_" + mode] += count * ms[key]
                rows[key]["device_ms" + sfx] += count * dev_ms[key]
                rows[key]["ms_fma_f32" + sfx] += count * fma[key]
            if not rate:
                rows["fwd"]["device_ms_" + mode] += count * dev_ms["fwd"]
            if tiled and wsp == reso and not rate:
                # the same full-width bands in flash mode (no LePE, the same
                # mask tile N): the window mode's LePE epilogue is the difference
                band_ms = device_ms(torch, lambda: fa.kernel_fwd(q, k, v, None, **kwr,
                                                                 mode="flash"))
                rows["fwd"]["bands_window_ms"] += count * dev_ms["fwd"]
                rows["fwd"]["bands_flash_ms"] += count * band_ms
                log(f"    the same bands in flash mode, without the LePE: fwd device "
                    f"{band_ms:.4f} ms (window mode {dev_ms['fwd']:.4f})")
            log(f"    {mode} reso {reso} window {hsp}x{wsp} Cb {Cb} rate {rate} x{count}/step: "
                f"fwd {ms['fwd']:.4f} (device {dev_ms['fwd']:.4f}) dq {ms['dq']:.4f} (device "
                f"{dev_ms['dq']:.4f}) dkv {ms['dkv']:.4f} (device {dev_ms['dkv']:.4f}) ms  "
                f"CUDA-core body, f32: fwd {fma['fwd']:.4f} dq {fma['dq']:.4f} dkv "
                f"{fma['dkv']:.4f} ms  plain fwd {plain_f:.4f} bwd {plain_b:.4f} ms  sdpa fwd "
                f"{lib_f:.4f} bwd {lib_b:.4f} ms")
        stat = L * heads * 4
        taps = Cb * 9 * 4 if tiled else 0
        work = {"fwd": (4 * L * Cb * 2 + stat + taps, (4 * N + (18 if tiled else 0)) * L * Cb),
                "dq": (5 * L * Cb * 2 + 2 * stat, 6 * N * L * Cb),
                "dkv": (6 * L * Cb * 2 + 2 * stat + 2 * taps,
                        (8 * N + (36 if tiled else 0)) * L * Cb)}
        for key, (nbytes, flops) in work.items():
            rows[key]["bytes"] += count * nbytes
            rows[key]["flops"] += count * flops
            rows[key]["bound_ms_" + mode] += count * bound_ms(nbytes, flops, "bfloat16")[0]
        # exps and dropout hashes of the tensor-core bodies: one of each per
        # score, and a second exp in window-mode dq (its delta sweep, whose keep
        # bits the ds sweep reads back)
        scores = (reso // hsp) * (reso // wsp) * heads * N * N
        for key, exps in (("fwd", 1), ("dq", 2 if tiled else 1), ("dkv", 1)):
            rows[key]["exps"] += count * exps * scores
            rows[key]["hashes"] += count * scores
        del q, k, v, w, g, qh, kh, vh, gh, out, lse, delta, dq, q32, k32, v32, w32, g32
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["flops"], "bfloat16")
    for key, row in rows.items():
        add_floor(torch, row)
        log(f"  flash {key}, tensor-core body, per 2048^2 step: {row['ms']:.3f} / "
            f"{row['ms_drop']:.3f} ms at rate 0 / {DROP} (device {row['device_ms']:.3f} / "
            f"{row['device_ms_drop']:.3f}); CUDA-core body in float32 {row['ms_fma_f32']:.3f} / "
            f"{row['ms_fma_f32_drop']:.3f}; bound {row['bound_ms']:.4f} ({row['bound_by']}); "
            + floor_text(row))
    log(f"  flash fwd by mode, rate 0: window {rows['fwd']['ms_window']:.3f} ms (device "
        f"{rows['fwd']['device_ms_window']:.3f}, bound {rows['fwd']['bound_ms_window']:.4f}), "
        f"flash {rows['fwd']['ms_flash']:.3f} ms (device {rows['fwd']['device_ms_flash']:.3f}, "
        f"bound {rows['fwd']['bound_ms_flash']:.4f}); the step's full-width bands, device: "
        f"window mode {rows['fwd']['bands_window_ms']:.3f} ms, flash mode on the same bands "
        f"{rows['fwd']['bands_flash_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return rows


def launches_of(torch, _build, fn) -> dict:
    """Run ``fn()`` with every launch count set to 0 just before; the counts
    it launched, read just after (a main-path run)."""
    torch.cuda.synchronize()
    _build.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: n for k, n in _build.LAUNCHES.items() if n}


def remaining_kernels_phase(torch, F, dev, randn, _build, build_model, model, model448):
    """Phase 4c: the last six kernel bodies (K-LN, K-LN', K5 with and
    without the gate, K-V1, K-V1') against their plain versions at the
    shapes their entry points take in the flagship (bf16, batch 8) and in
    ``cswinunet`` (float32, batch 2), and at one odd shape each (K-LN' at
    four: one row, ragged last blocks, C off the vector width; dx, dg and
    db each also against its own max|plain| in float32 and bf16, and the
    body each K-LN' launch took; K-V1 and
    every output of K-V1' also against its own max|plain|, K-V1''s masked
    keys with dk = dv = 0 exactly, and the body each launch took: bf16 at
    head dims 16-64 the tensor-core ones, float32 the CUDA-core ones; K5's
    dx and db also against their own max|plain|, at a 7 x 9 map, and with
    dy = 0 and A, B of order 100, where dx is the two pooled terms alone);
    their times at the flagship's shapes (K-V1 and K-V1' on the device
    beside SDPA's device time; K5 and K5 without the gate also on the device
    at the 2048^2 head and at cswinunet's float32 one, with their SFU and ALU
    floors; K-LN' also on the device at cswinunet's four float32 shapes,
    beside F.layer_norm's backward); then the three entry points driven forward and
    backward with the launch counts reset before and read after each
    (FusedLayerNorm(use_kernel=True) at every LayerNorm shape of both
    configs; CARAFE(flat_output, flat_raw) into FusedSimAMHead at 1 and 4
    classes with the gate on and off, and at 16 classes through the unfused
    chain; stripe_attention_v1 at every window geometry of both configs,
    with its body launches);
    FusedSimAMHead with kernels on against off; and one batch-8 serving
    forward of CSWin-SimAM-UNet with 16 classes at 512^2, whose head takes
    the unfused chain.  Returns the six kernel-table entries and a summary."""
    from cswin_simam_unet_tpu_torch.models.layers import CARAFE, FusedLayerNorm, FusedSimAMHead
    from cswin_simam_unet_tpu_torch.ops import attention, carafe_head, carafe_kernels
    from cswin_simam_unet_tpu_torch.ops import layernorm, simam_head
    from cswin_simam_unet_tpu_torch.ops import stripe_attention as sa
    from cswin_simam_unet_tpu_torch.ops import window_attention as wa
    from cswin_simam_unet_tpu_torch.ops.simam import pooled_stats

    rows = {k: dict(err32=0.0, err16=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0,
                    flops=0.0, device_ms=0.0, library_device_ms=0.0, shapes=[])
            for k in ("K-LN", "K-LN'", "K5", "K5 no gate", "K-V1", "K-V1'")}

    def fold(key, errs):
        """Keep the largest errors: (f32, bf16) of check_pair, (f32 scaled,
        bf16 scaled, f32 absolute) of check_outputs."""
        for name, err in zip(("err32", "err16", "abs32"), errs):
            rows[key][name] = max(rows[key].get(name, 0.0), err)

    def add_time(key, times, nbytes, flops, shape, count=1):
        """Fold one shape's times into the row: ``times`` (kernel, plain,
        library or None) as callables, each timed with CUDA events (time_ms)
        and the kernel and library also without the host's time (device_ms); all
        times ``count`` x per call."""
        kern, plain, lib = times
        ms, plain_ms = count * time_ms(torch, kern), count * time_ms(torch, plain, iters=3)
        dev = count * device_ms(torch, kern)
        lib_ms = lib_dev = None
        if lib is not None:
            lib_ms, lib_dev = count * time_ms(torch, lib), count * device_ms(torch, lib)
        r = rows[key]
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["device_ms"] += dev
        r["library_ms"] = None if lib is None else r["library_ms"] + lib_ms
        r["library_device_ms"] = None if lib is None else r["library_device_ms"] + lib_dev
        r["bytes"] += count * nbytes
        r["flops"] += count * flops
        b_ms, _ = bound_ms(count * nbytes, count * flops, "bfloat16")
        r["shapes"].append(dict(shape=shape, ms=ms, device_ms=dev, plain_ms=plain_ms,
                                library_ms=lib_ms, library_device_ms=lib_dev, bound_ms=b_ms))
        log(f"    {key} {shape}: kernel {ms:.4f} ms (device {dev:.4f})  plain {plain_ms:.4f} "
            f"ms  library {'none' if lib is None else f'{lib_ms:.4f} ms (device {lib_dev:.4f})'}"
            f"  bound {b_ms:.4f} ms")

    # -- K-LN, K-LN': every LayerNorm shape (rows M = B*L, channels C) --
    E, r512, r448 = 64, IMG // 4, IMG448 // 4
    B448 = 2
    ln_flag = [(TIME_BATCH * (r512 >> s) ** 2, E << s) for s in range(4)]
    ln_448 = [(B448 * (r448 >> s) ** 2, E << s) for s in range(4)]
    def ln_inputs(M, C, dtype, grad=False):
        """(x, scale, bias), or (x, scale, dy) with ``grad``."""
        x, g = randn(M, C, scale=2.0, dtype=dtype), randn(C, scale=0.3) + 1.0
        return x, g, randn(M, C, dtype=dtype) if grad else randn(C, scale=0.1)

    # odd shapes: C off the vector width (the scalar body in bf16, or in
    # both), one row, ragged last blocks
    for M, C in ln_flag + ln_448 + [(1000, 100), (37, 33), (1, 8), (2049, 512), (263 * 8 + 1, 64)]:
        fold("K-LN", check_pair(f"K-LN ({M}, {C})", torch, layernorm.kernel_fwd,
                                layernorm.ln_reference,
                                lambda _B, dtype, M=M, C=C: ln_inputs(M, C, dtype)))
        _build.reset_launches()
        fold("K-LN'", check_outputs(f"K-LN' ({M}, {C})", torch, layernorm.kernel_bwd,
                                    layernorm.ln_bwd_reference,
                                    lambda _B, dtype, M=M, C=C: ln_inputs(M, C, dtype, True),
                                    own=(0, 1, 2), ratios=rows["K-LN'"], own32=True))
        want = {}  # float32 loads 4 a vector, bf16 8
        for per16 in (4, 8):
            key = f"{layernorm.BWD_KERNEL}:{'vec' if C % per16 == 0 else 'scalar'}"
            want[key] = want.get(key, 0) + 1
        bodies = {k: n for k, n in _build.BODY_LAUNCHES.items() if n}
        require(bodies == want, f"K-LN' ({M}, {C}): body launches {bodies} != {want}")
    for M, C in ln_flag:  # times at the flagship's shapes, bf16
        x, g, dy = ln_inputs(M, C, torch.bfloat16, True)
        b = randn(C, scale=0.1)
        gb, bb = g.to(x.dtype), b.to(x.dtype)
        xg, gg, bg = (t.detach().requires_grad_() for t in (x, gb, bb))
        lib_out = F.layer_norm(xg, (C,), gg, bg, 1e-5)
        add_time("K-LN", (lambda: layernorm.kernel_fwd(x, g, b),
                          lambda: layernorm.ln_reference(x, g, b),
                          lambda: F.layer_norm(x, (C,), gb, bb, 1e-5)),
                 2 * M * C * 2 + 2 * C * 4, 8 * M * C, (M, C))
        add_time("K-LN'", (lambda: layernorm.kernel_bwd(x, g, dy),
                           lambda: layernorm.ln_bwd_reference(x, g, dy),
                           lambda: torch.autograd.grad(lib_out, (xg, gg, bg), dy,
                                                       retain_graph=True)),
                 3 * M * C * 2 + 3 * C * 4, 14 * M * C, (M, C))
        del x, g, dy, xg, lib_out
    r = rows["K-LN'"]
    r["device_ms_448"] = r["bound_ms_448"] = r["library_device_ms_448"] = 0.0
    r["per_shape_448"] = []
    for M, C in ln_448:  # K-LN' on the device at cswinunet's shapes, float32
        x, g, dy = ln_inputs(M, C, torch.float32, True)
        xg, gg, bg = (t.detach().requires_grad_() for t in (x, g, randn(C, scale=0.1)))
        lib_out = F.layer_norm(xg, (C,), gg, bg, 1e-5)
        dev_ms = device_ms(torch, lambda: layernorm.kernel_bwd(x, g, dy))
        lib_dev = device_ms(torch, lambda: torch.autograd.grad(lib_out, (xg, gg, bg), dy,
                                                               retain_graph=True))
        b_ms, _ = bound_ms(3 * M * C * 4 + 3 * C * 4, 14 * M * C, "float32")
        r["device_ms_448"] += dev_ms
        r["library_device_ms_448"] += lib_dev
        r["bound_ms_448"] += b_ms
        r["per_shape_448"].append(dict(shape=(M, C), device_ms=dev_ms,
                                       library_device_ms=lib_dev, bound_ms=b_ms))
        log(f"    K-LN' ({M}, {C}) float32: device {dev_ms:.4f} ms  library device "
            f"{lib_dev:.4f} ms  bound {b_ms:.4f} ms")
        del x, g, dy, xg, lib_out

    # -- K5 and K5 without the gate: the flagship head's flat map --
    G = 16

    def make_k5(H, W, C, Fc, gate, pooled_only=False):
        """K5's inputs; with ``pooled_only`` dy = 0 and A, B of order 100,
        so that dx is the two pooled terms alone (about 1/N of dx else)."""
        def make(B, dtype):
            fb = randn(B, H, W, G * C, dtype=dtype)
            dy = randn(B, H, W, G * Fc, dtype=dtype)
            w = randn(C, Fc, scale=C ** -0.5)
            f = fb.float()
            mu, v = pooled_stats(f.sum((1, 2)), (f * f).sum((1, 2)), H * W * G, G)
            A = Bq = torch.zeros_like(mu)  # unused without the gate
            if pooled_only:
                dy.zero_()
                A, Bq = randn(B, C, scale=100.0), randn(B, C, scale=100.0)
            elif gate:
                A, Bq, _ = carafe_head.head_bwd1_reference(f, dy.float(), mu, v, w, G)
            return fb, dy, mu, v, A, Bq, w
        return make

    def k5_bytes(fb, dy, gate):
        """Bytes K5 must move: dx written, dy read, W; with the gate fb read
        and the (B, C) float32 mu, v, A, B."""
        n = fb.numel()
        return ((2 * n if gate else n) * fb.element_size() + dy.numel() * dy.element_size()
                + E * 4 + (4 * fb.shape[0] * E * 4 if gate else 0))

    for gate in (True, False):
        key = "K5" if gate else "K5 no gate"
        # the flagship's map at 1 and 4 classes, and 7 x 9 pixels at 5 classes
        # (a map that fills neither a chunk nor U pixels), each output also at
        # its own max|plain|
        for H, W, C, Fc in ((r512, r512, E, 1), (r512, r512, E, 4), (20, 36, 48, 3),
                            (7, 9, E, 5)):
            fold(key, check_outputs(
                f"{key} fb ({H},{W},{G * C}) F {Fc}", torch,
                lambda *a, gate=gate: simam_head.head_bwd2(*a, G, gate=gate),
                lambda *a, gate=gate: carafe_head.head_bwd2_reference(*a, G, gate=gate),
                make_k5(H, W, C, Fc, gate), own=(0, 1), ratios=rows[key]))
        if gate:  # the pooled terms alone: dy = 0, A and B of order 100
            fold(key, check_outputs(
                f"{key} fb ({r512},{r512},{G * E}) F 1, dy = 0, |A|, |B| ~ 100", torch,
                lambda *a: simam_head.head_bwd2(*a, G),
                lambda *a: carafe_head.head_bwd2_reference(*a, G),
                make_k5(r512, r512, E, 1, True, pooled_only=True), own=(0, 1),
                ratios=rows[key]))
        args = make_k5(r512, r512, E, 1, gate)(TIME_BATCH, torch.bfloat16)
        n = args[0].numel()
        add_time(key, (lambda: simam_head.head_bwd2(*args, G, gate=gate),
                       lambda: carafe_head.head_bwd2_reference(*args, G, gate=gate), None),
                 k5_bytes(args[0], args[1], gate),
                 (24 if gate else 3) * n, (TIME_BATCH, r512, r512, G * E))
        rows[key]["floors"] = head_floor_text(torch, n, n // (G * E), G, key)
        log(f"    {key}: {rows[key]['floors']}")
        del args
        # device time at the 2048^2 head (batch 1, bf16) and at cswinunet's
        # (448^2, batch 2, float32)
        for label, B, r, dtype in (("2048", 1, IMG2048 // 4, torch.bfloat16),
                                   ("448", B448, r448, torch.float32)):
            args = make_k5(r, r, E, 1, False)(B, dtype)
            if gate:  # stand-in A and B: K5's time does not depend on them
                args = (*args[:4], randn(B, E), randn(B, E), args[6])
            dms = device_ms(torch, lambda: simam_head.head_bwd2(*args, G, gate=gate))
            b_ms, _ = bound_ms(k5_bytes(args[0], args[1], gate), 0, "bfloat16")
            rows[key][f"device_ms_{label}"] = dms
            rows[key][f"bound_ms_{label}"] = b_ms
            log(f"    {key} at the {label}^2 head, batch {B}, {dtype}: device {dms:.4f} ms, "
                f"bound {b_ms:.4f} ms")
            del args
            torch.cuda.empty_cache()

    # -- K-V1, K-V1': every window geometry, as (G, Np, D) groups --
    def v1_shape(B, reso, Cb, heads, hsp, wsp):
        N = hsp * wsp
        return B * (reso // hsp) * (reso // wsp) * heads, -(-N // wa.PAD) * wa.PAD, N, Cb // heads

    geoms512, geoms448 = attention_geometries(model), attention_geometries(model448)
    v1_cases = sorted({v1_shape(1, *g)[1:] for g in list(geoms512) + list(geoms448)})
    for Np, nv, D in v1_cases + [(64, 53, 16)]:
        scale = D ** -0.5

        def make(B, dtype, Np=Np, D=D, grad=False):
            return [randn(B * 8, Np, D, scale=0.5, dtype=dtype) for _ in range(4 if grad else 3)]

        def v1_bwd(q, k, v, do, s=scale, nv=nv):
            dq, dk, dv = wa.kernel_bwd(q, k, v, wa.kernel_fwd(q, k, v, s, nv)[1], do, s, nv)
            require(float(dk[:, nv:].abs().sum()) == 0.0 and float(dv[:, nv:].abs().sum()) == 0.0,
                    f"K-V1' (G, {Np}, {D}), n_valid {nv}: masked keys with dk or dv != 0")
            return dq, dk, dv

        name = f"(G, {Np}, {D}), n_valid {nv}"
        _build.reset_launches()
        *errs, own32, own16 = check_pair(
            "K-V1 " + name, torch, lambda q, k, v, s=scale, nv=nv: wa.kernel_fwd(q, k, v, s, nv)[0],
            lambda q, k, v, s=scale, nv=nv: wa.window_attention_reference(q, k, v, s, nv), make,
            own=True)
        fold("K-V1", errs)
        rows["K-V1"]["own16"] = max(rows["K-V1"].get("own16", 0.0), own16)
        # every output of K-V1' also against its own max|plain| (dq, dk, dv
        # are far below 1 at these inputs; the max(1, .) floor alone passed
        # a dq at 0.9x in the other attention kernels)
        fold("K-V1'", check_outputs("K-V1' " + name, torch, v1_bwd,
                                    lambda q, k, v, do, s=scale, nv=nv:
                                    wa.window_attention_bwd_reference(q, k, v, do, s, nv),
                                    lambda B, dtype, make=make: make(B, dtype, grad=True),
                                    own=(0, 1, 2)))
        # each check ran K-V1 twice and K-V1' once in float32, and again in bf16
        bodies = {n: c for n, c in _build.BODY_LAUNCHES.items() if c}
        want = ({f"{wa.FWD_KERNEL}:fma": 2, f"{wa.BWD_KERNEL}:fma": 1,
                 f"{wa.FWD_KERNEL}:mma": 2, f"{wa.BWD_KERNEL}:mma": 1}
                if D in wa.MMA_HEAD_DIMS else {f"{wa.FWD_KERNEL}:fma": 4, f"{wa.BWD_KERNEL}:fma": 2})
        require(bodies == want, f"K-V1 {name}: body launches {bodies} != {want}: float32 takes "
                "the CUDA-core bodies, bf16 at head dims 16-64 the tensor-core ones")
        log(f"    K-V1 / K-V1' {name}: bodies {bodies}; bf16 K-V1' body "
            f"{wa.design(torch.bfloat16, D, Np)}")
    for geom, count in sorted(geoms512.items()):  # the flagship's 50 branches, bf16
        Gn, Np, nv, D = v1_shape(TIME_BATCH, *geom)
        scale = D ** -0.5
        for key in ("K-V1", "K-V1'"):  # K-V1''s body at each flagship window
            rows[key].setdefault("design", {})[f"{Np}x{D}"] = wa.design(torch.bfloat16, D, Np)
        q, k, v, do = (randn(Gn, Np, D, scale=0.5, dtype=torch.bfloat16) for _ in range(4))
        _, lse = wa.kernel_fwd(q, k, v, scale, nv)
        mask = (torch.arange(Np, device=dev) < nv).view(1, 1, 1, Np)
        qg, kg, vg = (t[:, None].detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
        elems = Gn * Np * D
        add_time("K-V1", (lambda: wa.kernel_fwd(q, k, v, scale, nv),
                          lambda: wa.window_attention_reference(q, k, v, scale, nv),
                          lambda: F.scaled_dot_product_attention(
                              q[:, None], k[:, None], v[:, None], attn_mask=mask, scale=scale)),
                 4 * elems * 2 + Gn * Np * 4, 4 * Gn * Np * nv * D, (geom, count), count)
        add_time("K-V1'", (lambda: wa.kernel_bwd(q, k, v, lse, do, scale, nv),
                           lambda: wa.window_attention_bwd_reference(q, k, v, do, scale, nv),
                           lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do[:, None],
                                                       retain_graph=True)),
                 7 * elems * 2 + Gn * Np * 4, 10 * Gn * Np * nv * D, (geom, count), count)
        del q, k, v, do, lse, qg, kg, vg, lib_out
    torch.cuda.empty_cache()

    # -- the three entry points, forward and backward: the main path --
    main = {}

    def tally(label, got, want):
        log(f"  {label}: launches {got}")
        require(got == want, f"{label}: launches {got} != {want}")
        for k_, n_ in got.items():
            main[k_] = main.get(k_, 0) + n_

    for (M, C), dtype in [(s, torch.bfloat16) for s in ln_flag] + [(s, torch.float32)
                                                                   for s in ln_448]:
        def run_ln(M=M, C=C, dtype=dtype):
            mod = FusedLayerNorm(C, use_kernel=True).to(dev)
            with torch.no_grad():
                mod.weight.copy_(randn(C, scale=0.3) + 1.0)
                mod.bias.copy_(randn(C, scale=0.1))
            x = randn(M, C, dtype=dtype).requires_grad_()
            y = mod(x)
            y.backward(randn(M, C, dtype=dtype))
            require(y.dtype == dtype and bool(torch.isfinite(y).all())
                    and bool(torch.isfinite(x.grad).all())
                    and bool(torch.isfinite(mod.weight.grad).all()),
                    f"FusedLayerNorm ({M}, {C}) {dtype}: non-finite output or gradient")

        tally(f"FusedLayerNorm(use_kernel=True) ({M}, {C}) {dtype}",
              launches_of(torch, _build, run_ln),
              {layernorm.FWD_KERNEL: 1, layernorm.BWD_KERNEL: 1})
        bodies = {k: n for k, n in _build.BODY_LAUNCHES.items() if n}
        require(bodies == {f"{layernorm.BWD_KERNEL}:vec": 1},
                f"FusedLayerNorm ({M}, {C}) {dtype}: K-LN' bodies {bodies}")
        rows["K-LN'"]["launches_vec"] = rows["K-LN'"].get("launches_vec", 0) + 1

    tokens = randn(TIME_BATCH, r512 * r512, E, dtype=torch.bfloat16)
    for Fc, gate in ((1, True), (1, False), (4, True), (4, False), (16, True)):
        def run_head(Fc=Fc, gate=gate):
            car = CARAFE(E, E, up_factor=4, flat_output=True, flat_raw=True).to(dev)
            head = FusedSimAMHead(E, Fc, G, use_simam=gate).to(dev)
            with torch.no_grad():
                for p_ in list(car.parameters()) + list(head.parameters()):
                    p_.copy_(randn(*p_.shape, scale=p_[0].numel() ** -0.5 if p_.ndim > 1
                                   else 0.1))
            x = tokens.detach().requires_grad_()
            up, bias = car(x, r512, r512, kernels=True)
            out = head(up, bias)
            out.float().square().mean().backward()
            require(tuple(out.shape) == (TIME_BATCH, r512, r512, G * Fc)
                    and bool(torch.isfinite(out).all()) and bool(torch.isfinite(x.grad).all())
                    and bool(torch.isfinite(head.weight.grad).all()),
                    f"FusedSimAMHead F {Fc} gate {gate}: bad output or gradient")

        want = {carafe_kernels.KERNEL: 1, carafe_kernels.BWD_KERNEL: 1}
        if Fc <= 8:
            want.update({carafe_head.HEAD_KERNEL: 1,
                         carafe_head.BWD1_KERNEL if gate else carafe_head.BWD1_NOGATE_KERNEL: 1,
                         simam_head.BWD2_KERNEL if gate else simam_head.BWD2_NOGATE_KERNEL: 1})
        tally(f"CARAFE(flat_raw) -> FusedSimAMHead F {Fc} gate {gate}, batch {TIME_BATCH} bf16",
              launches_of(torch, _build, run_head), want)
    del tokens

    def run_v1(geoms, B, dtype):
        worst = 0.0
        for (reso, Cb, heads, hsp, wsp) in sorted(geoms):
            kw = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads)
            q, k, v = (randn(B, reso * reso, Cb, scale=0.5, dtype=dtype).requires_grad_()
                       for _ in range(3))
            lepe = randn(3, 3, 1, Cb, scale=1 / 3, dtype=dtype)
            out = wa.stripe_attention_v1(q, k, v, lepe, **kw)
            out.backward(randn(B, reso * reso, Cb, dtype=dtype))
            require(bool(torch.isfinite(out).all()) and bool(torch.isfinite(q.grad).all()),
                    f"stripe_attention_v1 {kw}: non-finite")
            if dtype == torch.float32:  # v1 and K-A's plain version: one function
                with torch.no_grad():
                    ref = attention.stripe_attention(q, k, v, lepe, **kw)
                worst = max(worst, max_err(out.detach(), ref))
        return worst

    for label, geoms, B, dtype in (("cswin_simam_512", geoms512, TIME_BATCH, torch.bfloat16),
                                   ("cswinunet", geoms448, B448, torch.float32)):
        res = {}
        tally(f"stripe_attention_v1 at the {len(geoms)} window geometries of {label}, batch "
              f"{B}, {dtype}", launches_of(torch, _build, lambda: res.setdefault(
                  "err", run_v1(geoms, B, dtype))),
              {wa.FWD_KERNEL: len(geoms), wa.BWD_KERNEL: len(geoms)})
        # bf16 at head dim 32: the tensor-core bodies; float32: the CUDA-core ones
        body = "mma" if dtype == torch.bfloat16 else "fma"
        bodies = {n: c for n, c in _build.BODY_LAUNCHES.items() if c}
        log(f"  stripe_attention_v1, {label}: body launches {bodies}")
        require(bodies == {f"{wa.FWD_KERNEL}:{body}": len(geoms),
                           f"{wa.BWD_KERNEL}:{body}": len(geoms)},
                f"stripe_attention_v1 {label}: body launches {bodies}")
        for key in ("K-V1", "K-V1'"):
            rows[key][f"launches_{body}"] = len(geoms)
        if dtype == torch.float32:
            log(f"  stripe_attention_v1 vs the plain stripe attention, float32: max abs err "
                f"{res['err']:.3e} (tol {TOL_F32:g})")
            require(res["err"] <= TOL_F32, f"v1 vs plain stripe attention {res['err']}")
    # attention dropout in training: the documented fallback, no v1 launch
    geom = sorted(geoms512)[0]
    kw = dict(H=geom[0], W=geom[0], hsp=geom[3], wsp=geom[4], num_heads=geom[2],
              attn_drop=DROP, deterministic=False, seed=DROP_SEED)
    q = randn(2, geom[0] ** 2, geom[1], scale=0.5, dtype=torch.bfloat16)
    fallback = launches_of(torch, _build, lambda: wa.stripe_attention_v1(
        q, q, q, randn(3, 3, 1, geom[1], dtype=torch.bfloat16), **kw))
    log(f"  stripe_attention_v1 with attention dropout 0.3 in training: launches {fallback}")
    require(not any(k_.startswith("csu_window_attention") for k_ in fallback),
            "the v1 dropout fallback launched a v1 kernel")
    for key, fn in (("K-LN", layernorm.FWD_KERNEL), ("K-LN'", layernorm.BWD_KERNEL),
                    ("K5", simam_head.BWD2_KERNEL), ("K5 no gate", simam_head.BWD2_NOGATE_KERNEL),
                    ("K-V1", wa.FWD_KERNEL), ("K-V1'", wa.BWD_KERNEL)):
        rows[key]["launches"] = main.get(fn, 0)
        require(rows[key]["launches"] > 0, f"{key} was not launched on its main path")
    log(f"  main-path launches of the three entry points: {main}")

    # -- FusedSimAMHead, kernels on against off --
    head_gaps = {}
    for Fc, gate in ((1, True), (4, True), (4, False)):
        head = FusedSimAMHead(E, Fc, G, use_simam=gate).to(dev)
        with torch.no_grad():
            head.weight.copy_(randn(Fc, E, 1, 1, scale=E ** -0.5))
        x0, b0 = randn(2, r512, r512, G * E), randn(E, scale=0.1)
        res = []
        for on in (True, False):
            x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
            head.weight.grad = None
            out = head(x, b, use_kernels=on)
            out.backward(torch.cos(out.detach()))
            res.append((out.detach(), x.grad, b.grad, head.weight.grad.clone()))
        gap = max(max_err(a, r) / max(float(r.abs().max()), 1e-30)
                  for a, r in zip(res[0], res[1]))
        with torch.no_grad():
            xb, bb = x0[:1].to(torch.bfloat16), b0.to(torch.bfloat16)
            dp = max_err(torch.sigmoid(head(xb, bb, use_kernels=True).float()),
                         torch.sigmoid(head(xb, bb, use_kernels=False).float()))
        log(f"  FusedSimAMHead F {Fc} gate {gate}, kernels on vs off: float32 output and "
            f"gradients within {gap:.3e} x max|.| (tol {TOL_GRAD_F32:g}); bf16 sigmoid "
            f"max |dp| {dp:.3e} (tol {TOL_MODEL_BF16:g})")
        require(gap <= TOL_GRAD_F32, f"FusedSimAMHead F {Fc} gate {gate}: f32 gap {gap}")
        require(dp <= TOL_MODEL_BF16, f"FusedSimAMHead F {Fc} gate {gate}: bf16 gap {dp}")
        head_gaps[f"F{Fc}_gate{int(gate)}"] = dict(f32_rel=gap, bf16_dp=dp)
        del x0, res
    torch.cuda.empty_cache()

    # -- serving forward of CSWin-SimAM-UNet with 16 classes, 512^2, bf16 --
    model16 = build_model("cswin_simam_512", device=dev, seed=SEED, num_classes=16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    x16 = torch.rand(TIME_BATCH, IMG, IMG, 3, device=dev, generator=gen)
    n_attn = sum(geoms512.values())
    res = {}

    def serve16():
        with torch.inference_mode():
            res["p"] = model16.predict(x16)

    got = launches_of(torch, _build, serve16)
    log(f"  CSWin-SimAM-UNet, 16 classes, batch {TIME_BATCH}: launches {got}")
    require(got == {sa.KERNEL: n_attn, carafe_kernels.KERNEL: 4},
            f"16-class forward launches {got}")
    p = res.pop("p")
    sums = p.float().sum(-1)
    require(tuple(p.shape) == (TIME_BATCH, IMG, IMG, 16) and bool(torch.isfinite(p).all())
            and float((sums - 1).abs().max()) <= 5e-2, "16-class probabilities")
    with torch.inference_mode():
        on = model16.predict(x16[:2], use_kernels=True).float()
        off = model16.predict(x16[:2], use_kernels=False).float()
    dp16 = max_err(on, off)
    log(f"  16 classes, kernels on vs off, bf16, batch 2: max |dp| {dp16:.3e} "
        f"(tol {TOL_MODEL_BF16:g})")
    require(dp16 <= TOL_MODEL_BF16, f"16-class model diff {dp16}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        serve16()
    torch.cuda.synchronize()
    ms16 = (time.perf_counter() - t0) / 3 * 1e3
    log(f"  16-class batch-{TIME_BATCH} forward: {ms16:.2f} ms, "
        f"{TIME_BATCH * 1e3 / ms16:.1f} images/s (mean of 3, host clock)")
    del model16, x16, p, on, off
    torch.cuda.empty_cache()
    for r in rows.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["flops"], "bfloat16")
    # what K-LN and K-LN' would cost per flagship training step if its 58
    # LayerNorms took them (the model leaves them off, as the JAX model does)
    ln_count: dict = {}
    for mod in model.modules():
        if isinstance(mod, FusedLayerNorm):
            ln_count[mod.weight.shape[0]] = ln_count.get(mod.weight.shape[0], 0) + 1
    for key in ("K-LN", "K-LN'"):
        r = rows[key]
        for field in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                      "bound_ms"):
            r[f"{field}_flagship_step"] = sum(ln_count.get(sh["shape"][1], 0) * sh[field]
                                              for sh in r["shapes"])
        r["layernorms_per_flagship_step"] = ln_count
        log(f"  {key} per flagship step if its {sum(ln_count.values())} LayerNorms took it: "
            f"kernel {r['ms_flagship_step']:.4f} ms (device "
            f"{r['device_ms_flagship_step']:.4f})  plain {r['plain_ms_flagship_step']:.4f} ms  "
            f"F.layer_norm {r['library_ms_flagship_step']:.4f} ms (device "
            f"{r['library_device_ms_flagship_step']:.4f})  bound "
            f"{r['bound_ms_flagship_step']:.4f} ms")
    return rows, dict(head_on_off=head_gaps, classes16_max_abs_dp=dp16,
                      classes16_forward_ms=ms16, main_path_launches=main)


class StepCounts:
    """Inside ``with``: the training and eval steps that ``engine.fit``
    makes are wrapped so that each call's launches and body launches are
    recorded.  The counts live on the host, so reading them around a call
    waits for nothing on the device."""

    def __init__(self, engine, _build):
        self.engine, self._build = engine, _build
        self.calls: dict = {"train": [], "eval": []}

    def _wrap(self, kind, make):
        def maker(*args, **kw):
            step = make(*args, **kw)

            def counted(*a, **k):
                before = [dict(c) for c in (self._build.LAUNCHES, self._build.BODY_LAUNCHES)]
                out = step(*a, **k)
                self.calls[kind].append(tuple(
                    {key: n - was[key] for key, n in now.items() if n != was[key]}
                    for now, was in zip((self._build.LAUNCHES, self._build.BODY_LAUNCHES),
                                        before)))
                return out
            return counted
        return maker

    def __enter__(self):
        self.saved = self.engine.make_train_step, self.engine.make_eval_step
        self.engine.make_train_step = self._wrap("train", self.saved[0])
        self.engine.make_eval_step = self._wrap("eval", self.saved[1])
        return self

    def __exit__(self, *exc):
        self.engine.make_train_step, self.engine.make_eval_step = self.saved


def plateau_lrs(losses, lr, factor, patience, min_lr, threshold=1e-4, eps=1e-8) -> list:
    """The learning rate after each epoch of a reduce-on-plateau schedule
    (mode min, relative threshold, no cooldown), stated apart from torch's
    scheduler that ``fit`` steps."""
    best, bad, out = math.inf, 0, []
    for loss in losses:
        if loss < best * (1.0 - threshold):
            best, bad = loss, 0
        else:
            bad += 1
        if bad > patience:
            new = max(lr * factor, min_lr)
            lr = new if lr - new > eps else lr
            bad = 0
        out.append(lr)
    return out


def fit_phase(torch, engine, _build, model, tcfg, want_step, want_step_bodies, want_eval,
              want_eval_bodies) -> dict:
    """``engine.fit`` on a copy of ``model``: 2 epochs over in-memory loaders
    of host uint8 disc batches (3 training, 2 test), plateau patience 0.
    Every training step must launch ``want_step`` and every eval forward
    ``want_eval`` (the serving forward's kernels, no backward kernel); the
    history must hold 7 finite series of 2, Dice and IoU in [0, 1], and
    learning rates that the schedule's rule gives for its test losses."""
    from cswin_simam_unet_tpu_torch.train.schedule import make_plateau_scheduler
    img, batch = model.img_size, tcfg.batch_size
    phase(f"fit: {img}^2, {model.dtype}, batch {batch}, 2 epochs of 3 training and 2 test "
          f"batches, kernels on")
    trained = copy.deepcopy(model)
    opt = engine.make_optimizer(tcfg.optimizer, tcfg.learning_rate, tcfg.weight_decay,
                                trained.parameters())
    train = [disc_arrays(img, batch, seed=SEED + 10 + i) for i in range(3)]
    test = [disc_arrays(img, batch, seed=SEED + 20 + i) for i in range(2)]
    cfg = engine.FitConfig(num_epochs=2, augment=None, plateau_patience=0, seed=SEED)
    sched = make_plateau_scheduler(opt, cfg.plateau_factor, cfg.plateau_patience,
                                   cfg.plateau_min_lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StepCounts(engine, _build) as counts:
        history, global_step = engine.fit(trained, opt, train, test, cfg, scheduler=sched)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    require(global_step == 6, f"fit: global step {global_step}")
    calls = counts.calls
    require(len(calls["train"]) == 6 and len(calls["eval"]) == 4,
            f"fit: {len(calls['train'])} training and {len(calls['eval'])} eval steps")
    for i, (launched, bodies) in enumerate(calls["train"]):
        require(launched == want_step and bodies == want_step_bodies,
                f"fit training step {i}: launches {launched}, bodies {bodies}")
    for i, (launched, bodies) in enumerate(calls["eval"]):
        require(launched == want_eval and bodies == want_eval_bodies,
                f"fit eval forward {i}: launches {launched}, bodies {bodies}")
    log(f"each of the 6 training steps launched {calls['train'][0][0]}; each of the 4 eval "
        f"forwards {calls['eval'][0][0]} (bodies {calls['eval'][0][1]})")
    require(sorted(history) == sorted(engine.empty_history()), f"history keys {sorted(history)}")
    for key, series in history.items():
        require(len(series) == 2 and all(math.isfinite(v) for v in series),
                f"fit history {key}: {series}")
        if key.endswith(("dice", "iou")):
            require(all(0.0 <= v <= 1.0 for v in series), f"fit history {key}: {series}")
    want_lrs = plateau_lrs(history["test_loss"], tcfg.learning_rate, cfg.plateau_factor,
                           cfg.plateau_patience, cfg.plateau_min_lr)
    require(history["learning_rates"] == want_lrs
            and engine.get_learning_rate(opt) == want_lrs[-1],
            f"fit learning rates {history['learning_rates']} != {want_lrs}")
    epoch_ms = fit_s / 2 * 1e3
    ips = len(train) * batch * 2 / fit_s
    log(f"fit: {epoch_ms:.1f} ms per epoch ({len(train)} training and {len(test)} test "
        f"batches of {batch}), {ips:.1f} training images/s over the whole run (host clock, "
        f"synchronize at both ends, first epoch included); history "
        + json.dumps(history))
    del trained, opt
    torch.cuda.empty_cache()
    return dict(epoch_ms=epoch_ms, train_images_per_s=ips, history=history,
                step_launches=calls["train"][0][0], eval_launches=calls["eval"][0][0])


def grad_accum_phase(torch, engine, _build, build_model, no_drops, want_step, dev) -> dict:
    """``grad_accum=2`` against the full-batch step from the same weights
    (``cswin_simam_512``, float32, drops 0; AdamW at lr 0 keeps the
    weights): batch 4 (two equal micro-batches) and 3 (ragged, 1 + 2).
    Every parameter's gradient within TOL_GRAD_F32 x max|g|, loss, Dice and
    IoU within TOL_ACCUM relative, twice a step's launches; then the ms of
    each step (mean of ACCUM_STEPS after the checked one)."""
    phase("gradient accumulation: cswin_simam_512, float32, drops 0, grad_accum 2 vs 1")
    net = build_model("cswin_simam_512", device=dev, seed=SEED, dtype="float32", **no_drops)
    opt = engine.make_optimizer("adamw", 0.0, 0.0, net.parameters())
    out = {}
    for batch in (4, 3):
        images_d, masks_d = disc_batch(torch, net.img_size, batch, dev)
        res = {}
        for accum in (1, 2):
            step = engine.make_train_step(net, opt, grad_accum=accum, seed=SEED)
            launched = launches_of(torch, _build, lambda: res.__setitem__(
                accum, step(images_d, masks_d)))
            require(launched == {k: accum * n for k, n in want_step.items()},
                    f"batch {batch}, grad_accum {accum}: launches {launched}")
            grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
            t0 = time.perf_counter()
            for _ in range(ACCUM_STEPS):
                step(images_d, masks_d)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / ACCUM_STEPS * 1e3
            res[accum] = ({k: float(v) for k, v in res[accum].items()}, grads, ms)
        (full, g_full, ms_full), (acc, g_acc, ms_acc) = res[1], res[2]
        gaps = torch.stack([(g_acc[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)
                            for n, g in g_full.items()]).cpu()
        worst = float(gaps.max())
        require(worst <= TOL_GRAD_F32, f"batch {batch}: accumulated gradient gap {worst}")
        rel = {k: abs(acc[k] - full[k]) / max(abs(full[k]), 1e-30) for k in full}
        require(all(r <= TOL_ACCUM for r in rel.values()), f"batch {batch}: metrics {rel}")
        kind = "equal" if batch % 2 == 0 else "ragged"
        log(f"batch {batch} ({kind}): grad_accum 2 vs 1: largest gradient gap {worst:.3e} x "
            f"max|g| over {len(g_full)} parameters (tol {TOL_GRAD_F32:g}); loss {acc['loss']:.6f}"
            f" vs {full['loss']:.6f}, relative gaps "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f" (tol {TOL_ACCUM:g}); {ms_acc:.2f} ms a step vs {ms_full:.2f} (mean of "
            f"{ACCUM_STEPS}, host clock)")
        out[f"batch{batch}"] = dict(grad_gap=worst, rel=rel, ms_accum2=ms_acc, ms_full=ms_full)
    del net, opt
    torch.cuda.empty_cache()
    return out


DATA_DIR = os.path.join(HERE, "tests", "data", "discs")  # 24 image/mask JPEG pairs, 512^2
TOL_AUG = 1e-5                      # absolute, augmentation on [0, 1] data vs float64
AUG_DRAWS = 65536                   # draws whose frequencies are checked
AUG_SIGMA = 5                       # frequency bounds, in standard deviations
TOL_RESUME = 1e-6                   # max |param| gap, resumed vs unbroken fit: far below
                                    # one AdamW step (lr 1e-4), so a lost moment fails
TOL_RESUME_HISTORY = 1e-5           # max |metric| gap, resumed vs unbroken history
TOL_CLI_EVAL = 1e-4                 # evaluate vs the history's best epoch
CLI_TIMEOUT_S = 300


def decoder_probe() -> dict:
    """Which JPEG decoders this machine has: the native library (committed,
    or built from native/dataio.cpp; each tried in a child process), cv2,
    PIL."""
    from cswin_simam_unet_tpu_torch.data.dataset import decoders
    found = decoders()
    log(f"JPEG decoders: native {found['native']} ({found['native_status']}), "
        f"cv2 {found['cv2']}, PIL {found['pil']}")
    return found


def augment_phase(torch, dev) -> dict:
    """Augmentation on the card (the matrix form, TF32 switched on around
    it, which it must not use) at 512^2 batch 8 and 2048^2 batch 1:
    against float64 on the CPU from the same draws within TOL_AUG, nearest
    class-id masks exact, against the gather oracle on the card; the first
    samples with each k and flip forced; the draws' frequencies; device ms
    against the flop bound of its two products."""
    from cswin_simam_unet_tpu_torch.data import augment
    phase("augmentation on the card: 512^2 batch 8, 2048^2 batch 1")
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    out = {}
    for N, B in ((IMG, TIME_BATCH), (IMG2048, 1)):
        images = torch.rand(B, N, N, 3, generator=gen, device=dev)
        ids = torch.randint(0, 4, (B, N, N, 1), generator=gen, device=dev).float()
        row = {}
        for nearest in (False, True):
            cfg = augment.AugmentConfig(mask_nearest=nearest)
            masks = ids if nearest else (ids > 1).float()
            draws = list(augment.draw_params(gen, B, cfg))
            # forced: k = 0..3 on samples 0-3, hflip on 1, 4 and 6, vflip on
            # 2, 5 and 6; at batch 1 an odd k (the transposed path) and a flip
            for i in range(B):
                if i < 4:
                    draws[2][i] = i
                draws[0][i], draws[1][i] = i in (1, 4, 6), i in (2, 5, 6)
            if B == 1:
                draws[2][0], draws[0][0], draws[1][0] = (3, False, True) if nearest \
                    else (1, True, False)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                got = augment.augment_from_params(images, masks, *draws, cfg=cfg)
                torch.cuda.synchronize()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            ref = augment.augment_from_params(images.cpu().double(), masks.cpu().double(),
                                              *[d.cpu() for d in draws], cfg=cfg)
            oracle = augment.augment_gather(images, masks, *draws, cfg=cfg)
            err = max_err(got[0].cpu().double(), ref[0])
            err_mask = max_err(got[1].cpu().double(), ref[1])
            err_oracle = max(max_err(got[0], oracle[0]), max_err(got[1], oracle[1]))
            kind = "nearest" if nearest else "bilinear"
            log(f"  {N}^2 batch {B}, {kind} masks: |image - float64| {err:.3e}, |mask - "
                f"float64| {err_mask:.3e}, |matrix - gather| {err_oracle:.3e} (tol {TOL_AUG:g}"
                f"{', nearest masks exact' if nearest else ''}); k {draws[2].tolist()}, "
                f"hflip {draws[0].int().tolist()}, vflip {draws[1].int().tolist()}")
            require(err <= TOL_AUG and err_oracle <= TOL_AUG, f"augmentation {N}^2 {kind}")
            require(err_mask == 0.0 if nearest else err_mask <= TOL_AUG,
                    f"augmentation {N}^2 {kind}: masks {err_mask}")
            row[f"max_abs_err_{kind}"] = max(err, err_mask)
            row[f"max_abs_err_gather_{kind}"] = err_oracle
        cfg = augment.AugmentConfig()
        masks = (ids > 1).float()
        draws = augment.draw_params(gen, B, cfg)
        ms = time_ms(torch, lambda: augment.augment_from_params(images, masks, *draws, cfg=cfg))
        dev_ms = device_ms(torch, lambda: augment.augment_from_params(images, masks, *draws,
                                                                      cfg=cfg))
        draw_ms = time_ms(torch, lambda: augment.augment_batch(gen, images, masks, cfg))
        gather_ms = time_ms(torch, lambda: augment.augment_gather(images, masks, *draws,
                                                                   cfg=cfg), iters=3)
        flops = 2 * 2 * B * N * N * N * 4  # two products over the 4 channels of the pair
        nbytes = 4 * 2 * B * N * N * 4  # the image/mask pair read once and written once
        bound, by = bound_ms(nbytes, flops, "float32")
        log(f"  {N}^2 batch {B}: augment_from_params {ms:.3f} ms, device {dev_ms:.3f} ms; with "
            f"the draws (augment_batch) {draw_ms:.3f} ms, the gather form {gather_ms:.3f} ms "
            f"(CUDA events, mean of 10 / 3; device: behind a spin kernel); bound {bound:.3f} ms "
            f"by {by} ({flops / 1e9:.1f} GFLOP float32 at {PEAK_FLOPS['float32'] / 1e12:.0f} "
            f"TFLOP/s)")
        row.update(ms=ms, device_ms=dev_ms, ms_with_draws=draw_ms, gather_ms=gather_ms,
                   bound_ms=bound, bound_by=by, gflop=flops / 1e9)
        out[f"{N}x{B}"] = row
        del images, ids, masks
    # the draws' frequencies
    hflip, vflip, k, scale, top_u, left_u = augment.draw_params(gen, AUG_DRAWS)
    n = AUG_DRAWS
    freq = {"hflip": float(hflip.float().mean()), "vflip": float(vflip.float().mean())}
    want = {"hflip": 0.5, "vflip": 0.5}
    for j in range(4):
        freq[f"k{j}"] = float((k == j).float().mean())
        want[f"k{j}"] = 1 - 0.25 * 0.75 if j == 0 else 0.25 * 0.25
    for name, p in want.items():
        bound = AUG_SIGMA * math.sqrt(p * (1 - p) / n)
        require(abs(freq[name] - p) <= bound, f"draw frequency {name} {freq[name]} vs {p}")
    s_min, s_max, s_mean = float(scale.min()), float(scale.max()), float(scale.mean())
    u_bound = AUG_SIGMA / math.sqrt(12 * n)
    require(0.75 <= s_min and s_max < 1.0 and abs(s_mean - 0.875) <= 0.25 * u_bound,
            f"scale draws {s_min} {s_max} {s_mean}")
    for u in (top_u, left_u):
        require(abs(float(u.mean()) - 0.5) <= u_bound, "crop position draws")
    log(f"  draw frequencies over {n}: " + ", ".join(f"{k_} {v:.4f} (p {want[k_]:.4f})"
                                                     for k_, v in freq.items())
        + f"; scale in [{s_min:.4f}, {s_max:.4f}], mean {s_mean:.4f}; bounds {AUG_SIGMA} sigma")
    out["draw_frequencies"] = freq
    torch.cuda.empty_cache()
    return out


class MemorySource:
    """The loader's source interface over in-memory disc images: where the
    machine has no JPEG decoder."""

    def __init__(self, n: int, img: int):
        self.images, self.masks = disc_arrays(img, n, seed=SEED + 40)

    def __len__(self):
        return len(self.images)

    def load(self, i):
        return self.images[i], self.masks[i]

    def load_batch(self, idx):
        return self.images[list(idx)], self.masks[list(idx)]


def files_phase(torch, engine, _build, build_model, model, tcfg, want_step, want_eval,
                decoders) -> dict:
    """``DataLoader`` -> ``device_prefetch`` -> ``fit`` of ``cswin_simam_512``
    (bf16, drops 0.3, batch 8) for 2 epochs with augmentation and a
    ``CheckpointStore``, from the 24 JPEG pairs (or an in-memory source where
    no decoder was found); every step's launches a training step's; then a
    fresh model and optimizer restore epoch 1 and train epoch 2, against the
    unbroken run; the loader's images/s, ms per epoch checkpointed and, without
    checkpoints, from files against the same batches in memory, checkpoint
    save ms and size."""
    import numpy as np
    from cswin_simam_unet_tpu_torch.data import (AugmentConfig, DataLoader,
                                                 SegmentationDataSource, train_test_indices)
    from cswin_simam_unet_tpu_torch.data import dataset
    from cswin_simam_unet_tpu_torch.train.checkpoint import CheckpointStore
    from cswin_simam_unet_tpu_torch.train.schedule import make_plateau_scheduler
    files = decoders["native"] or decoders["cv2"] or decoders["pil"]
    phase(f"data from {'files' if files else 'memory (no JPEG decoder)'}: DataLoader -> fit, "
          f"{IMG}^2, batch {tcfg.batch_size}, augmented, checkpointed, resumed")
    if files:
        source = SegmentationDataSource(os.path.join(DATA_DIR, "images"),
                                        os.path.join(DATA_DIR, "masks"), (IMG, IMG))
    else:
        source = MemorySource(24, IMG)
    train_idx, test_idx = train_test_indices(len(source), tcfg.test_split, tcfg.seed)
    batch = tcfg.batch_size

    def loaders():
        return (DataLoader(source, train_idx, batch, shuffle=True, seed=tcfg.seed),
                DataLoader(source, test_idx, batch, shuffle=False))

    # the loader alone: 2 passes over the 24 images (no cache)
    dataset.DECODES.clear()
    everything = DataLoader(source, None, batch, shuffle=False)
    t0 = time.perf_counter()
    n_img = sum(b[0].shape[0] for _ in range(2) for b in everything)
    load_s = time.perf_counter() - t0
    loader_ips = n_img / load_s
    decoded = dict(dataset.DECODES)
    log(f"loader: {n_img} images in {load_s * 1e3:.1f} ms, {loader_ips:.1f} images/s at batch "
        f"{batch} ({IMG}^2; decoders used {decoded or 'none: in memory'}; 4 decode threads, "
        f"host clock)")
    cfg = engine.FitConfig(num_epochs=2, augment=AugmentConfig(), seed=SEED, verbose=False)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    # cuDNN's convolution backward may add in any order unless told not to;
    # the resumed run must equal the unbroken one to far below one step
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        # the checkpointed run first (its first steps at the ragged batch
        # shapes warm them up), then files and memory without checkpoints
        for label in ("unbroken", "files", "memory"):
            net = copy.deepcopy(model)
            opt = engine.make_optimizer(tcfg.optimizer, tcfg.learning_rate, tcfg.weight_decay,
                                        net.parameters())
            sched = make_plateau_scheduler(opt, cfg.plateau_factor, cfg.plateau_patience,
                                           cfg.plateau_min_lr)
            train, test = loaders()
            store = None
            if label == "memory":  # the same batches, decoded once before
                train.set_epoch(0)
                train = [b for b in train]
                test = [b for b in test]
            elif label == "unbroken":
                store = CheckpointStore(os.path.join(workdir, "ck"))
            run_cfg = dataclasses.replace(cfg, checkpoint_manager=store)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with StepCounts(engine, _build) as counts:
                history, step = engine.fit(net, opt, train, test, run_cfg, scheduler=sched)
            torch.cuda.synchronize()
            epoch_ms = (time.perf_counter() - t0) / 2 * 1e3
            n_train = len(counts.calls["train"])
            require(n_train == 2 * math.ceil(len(train_idx) / batch), f"{label}: {n_train} steps")
            for i, (launched, _) in enumerate(counts.calls["train"]):
                require(launched == want_step, f"{label} fit step {i}: launches {launched}")
            for i, (launched, _) in enumerate(counts.calls["eval"]):
                require(launched == want_eval, f"{label} fit eval {i}: launches {launched}")
            for key, series in history.items():
                require(len(series) == 2 and all(math.isfinite(v) for v in series),
                        f"{label} history {key}: {series}")
                if key.endswith(("dice", "iou")):
                    require(all(0.0 <= v <= 1.0 for v in series), f"{label} {key}: {series}")
            runs[label] = dict(net=net, opt=opt, sched=sched, history=history, step=step,
                               epoch_ms=epoch_ms, store=store)
            what = {"unbroken": "from the loader, checkpointed every epoch",
                    "files": "from the loader", "memory": "from the same batches in memory"}
            log(f"fit {what[label]}: {epoch_ms:.1f} ms per epoch ({n_train // 2} training "
                f"batches of up to {batch} and {len(test)} test batch, host clock, 2 epochs); "
                f"each step launched {counts.calls['train'][0][0]}; history "
                + json.dumps(history))
        store = runs["unbroken"]["store"]
        require(store.all_epochs() == [1, 2], f"checkpoints {store.all_epochs()}")
        # checkpoint save, timed alone, and its size
        ref = runs["unbroken"]
        probe = CheckpointStore(os.path.join(workdir, "probe"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe.save_epoch(2, ref["net"], ref["opt"], ref["sched"], ref["history"], 0.0,
                         ref["step"])
        save_ms = (time.perf_counter() - t0) * 1e3
        ck_bytes = os.path.getsize(os.path.join(probe.directory, "epoch_2.pt"))
        best_bytes = os.path.getsize(probe.best_weights_path())
        log(f"checkpoint save: {save_ms:.1f} ms for {ck_bytes / 2 ** 20:.1f} MiB (model, AdamW "
            f"moments, schedule, history) and the best weights ({best_bytes / 2 ** 20:.1f} MiB), "
            f"host clock, page cache warm")
        # a fresh model and optimizer restore epoch 1 and train epoch 2
        fresh = build_model("cswin_simam_512", device=model.device, seed=SEED + 7)
        opt2 = engine.make_optimizer(tcfg.optimizer, tcfg.learning_rate, tcfg.weight_decay,
                                     fresh.parameters())
        sched2 = make_plateau_scheduler(opt2, cfg.plateau_factor, cfg.plateau_patience,
                                        cfg.plateau_min_lr)
        t0 = time.perf_counter()
        sched_state, hist2, epoch, step2 = store.restore(fresh, opt2, epoch=1)
        restore_ms = (time.perf_counter() - t0) * 1e3
        sched2.load_state_dict(sched_state)
        train, test = loaders()
        hist2, step2 = engine.fit(fresh, opt2, train, test, cfg, history=hist2,
                                  scheduler=sched2, start_epoch=epoch, global_step=step2)
        torch.cuda.synchronize()
        gaps = torch.stack([(a.detach().float() - b.detach().float()).abs().max() for a, b in
                            zip(ref["net"].parameters(), fresh.parameters())]).cpu()
        gap = float(gaps.max())
        bit_equal = gap == 0.0
        hist_gap = max(abs(a - b) for k in hist2 for a, b in zip(hist2[k], ref["history"][k]))
        want_sched, got_sched = ref["sched"].state_dict(), sched2.state_dict()
        sched_diff = sorted(k for k in want_sched if k != "best"
                            and want_sched[k] != got_sched.get(k))
        best_gap = abs(want_sched["best"] - got_sched["best"])
        log(f"resumed from epoch 1 (restore {restore_ms:.1f} ms): global step {step2} vs "
            f"{ref['step']}; largest parameter gap to the unbroken run {gap:.3e} (tol "
            f"{TOL_RESUME:g}; bit-equal: {bit_equal}); largest history gap {hist_gap:.3e} "
            f"(tol {TOL_RESUME_HISTORY:g}); schedule fields that differ: {sched_diff or 'none'}, "
            f"best-loss gap {best_gap:.3e}; learning rate {engine.get_learning_rate(opt2):g} "
            f"vs {engine.get_learning_rate(ref['opt']):g}")
        require(step2 == ref["step"] and len(hist2["train_loss"]) == 2, "resumed fit: steps")
        require(gap <= TOL_RESUME, f"resumed fit: parameter gap {gap:.3e}")
        require(hist_gap <= TOL_RESUME_HISTORY, f"resumed fit: history gap {hist_gap:.3e}")
        require(not sched_diff and best_gap <= TOL_RESUME_HISTORY,
                f"resumed fit: schedule {sched_diff}, best-loss gap {best_gap:.3e}")
        require(engine.get_learning_rate(opt2) == engine.get_learning_rate(ref["opt"]),
                "resumed fit: learning rate")
        out = dict(decoders={k: v for k, v in decoders.items()}, from_files=bool(files),
                   loader_images_per_s=loader_ips, decoded=decoded,
                   epoch_ms_checkpointed=runs["unbroken"]["epoch_ms"],
                   epoch_ms_files=runs["files"]["epoch_ms"],
                   epoch_ms_memory=runs["memory"]["epoch_ms"], checkpoint_save_ms=save_ms,
                   checkpoint_mib=ck_bytes / 2 ** 20, best_weights_mib=best_bytes / 2 ** 20,
                   restore_ms=restore_ms, resume_max_param_gap=gap, resume_bit_equal=bit_equal,
                   resume_history_gap=hist_gap)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(workdir, ignore_errors=True)
    del runs
    torch.cuda.empty_cache()
    return out


def cli(args: list, label: str) -> str:
    """Run the port's CLI in a child process; its output, or fail."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "cswin_simam_unet_tpu_torch.cli", *args],
                         cwd=HERE, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    tail = "\n".join((res.stdout + res.stderr).strip().splitlines()[-12:])
    epochs = [line.strip() for line in res.stdout.splitlines() if line.startswith("Epoch [")]
    log(f"  cli {label}: exit {res.returncode} in {secs:.1f} s" + (
        f" ({'; '.join(epochs)})" if epochs else ""))
    require(res.returncode == 0, f"cli {label} failed:\n{tail}")
    return res.stdout


def cli_phase(decoders) -> dict:
    """The CLI as child processes at ``cswin_simam_512`` on the card:
    ``train --epochs 2``; ``train --resume --epochs 3`` ("Resumed from epoch
    2"); ``evaluate`` of the best weights on the test split, against the
    history's numbers for the best epoch; ``predict`` of the 24 images where
    cv2 or PIL can write PNGs."""
    import re
    phase("the CLI: train, train --resume, evaluate, predict (cswin_simam_512 on the card)")
    if not (decoders["native"] or decoders["cv2"] or decoders["pil"]):
        log("no JPEG decoder on this machine: the CLI reads JPEG files only; not run")
        return dict(ran=False)
    import torch
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        dirs = ["--image-dir", os.path.join(DATA_DIR, "images"),
                "--mask-dir", os.path.join(DATA_DIR, "masks")]
        common = ["--config", "cswin_simam_512", "--no-progress", *dirs, "--output-dir",
                  workdir]
        out = {}
        log_train = cli(["train", *common, "--epochs", "2"], "train --epochs 2")
        require("Epoch [2/2]" in log_train, "cli train: no second epoch")
        log_resume = cli(["train", *common, "--epochs", "3", "--resume"], "train --resume")
        require("Resumed from epoch 2" in log_resume and "Epoch [3/3]" in log_resume,
                "cli train --resume: did not resume from epoch 2")
        ckpt = os.path.join(workdir, "cswin_simam_512_checkpoints")
        with open(os.path.join(ckpt, "meta.json")) as f:
            best = json.load(f)["best_epoch"]
        history = torch.load(os.path.join(ckpt, "epoch_3.pt"), map_location="cpu",
                             weights_only=True)["history"]
        log_eval = cli(["evaluate", "--config", "cswin_simam_512", *dirs, "--weights",
                        os.path.join(ckpt, "best_weights.pth"), "--split", "test"], "evaluate")
        m = re.search(r"Loss: (\S+), Dice: (\S+), IoU: (\S+)", log_eval)
        require(m is not None, f"cli evaluate printed {log_eval!r}")
        got = dict(zip(("loss", "dice", "iou"), map(float, m.groups())))
        gaps = {k: abs(v - history[f"test_{k}"][best - 1]) for k, v in got.items()}
        log(f"  evaluate of the best epoch ({best}): {got}; gaps to the history "
            + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()) + f" (tol {TOL_CLI_EVAL:g})")
        require(all(g <= TOL_CLI_EVAL for g in gaps.values()), "cli evaluate vs history")
        out.update(ran=True, best_epoch=best, evaluate=got, evaluate_gaps=gaps)
        if decoders["cv2"] or decoders["pil"]:
            pred = os.path.join(workdir, "pred")
            log_pred = cli(["predict", "--config", "cswin_simam_512", "--image-dir", dirs[1],
                            "--weights", ckpt, "--output-dir", pred], "predict")
            n = len([p for p in os.listdir(pred) if p.endswith("_mask.png")])
            require(n == 24 and "Wrote 24 masks" in log_pred, f"cli predict wrote {n} masks")
            out["predicted_masks"] = n
        else:
            log("  predict not run: neither cv2 nor PIL can write the PNG masks here")
        png = "matplotlib is not installed" not in log_train
        log(f"  training plot written: {png}")
        out["plot_written"] = png
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


# ---- 8. the UNet family ----

TOL_UNET = 1e-4                     # x max(1, max|CPU|), float32 (TF32 off): the card
                                    # against the CPU, logits, metrics, statistics
TOL_UNET_GRAD = 1e-9                # float64 on both sides: each gradient x its own max|g|
SERVE_REPEATS = 5                   # timed requests per bucket, after one warm-up
UNET_IMG = 448                      # unet's resolution (unet_256 and unet_simam_256: 256)
# conv biases before a BatchNorm: the batch mean takes them out, so their
# gradient is rounding noise, held against their weight's max|g|
UNET_NOISE_BIASES = ("double_conv.0.bias", "double_conv.3.bias")


def unet_step_pair(torch, engine, _build, models, images, masks) -> list:
    """One Adam step of each model on the same uint8 batch: its metrics,
    gradients and buffers on the host, the port's launches and seconds."""
    runs = []
    for model in models:
        opt = engine.make_optimizer("adam", 1e-3, 1e-4, model.parameters())
        _build.reset_launches()
        t0 = time.perf_counter()
        m = engine.make_train_step(model, opt, 1)(images, masks)
        m = {k: float(v) for k, v in m.items()}
        secs = time.perf_counter() - t0
        launched = {k: n for k, n in _build.LAUNCHES.items() if n}
        runs.append((m, {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     {n: b.detach().cpu() for n, b in model.named_buffers()}, launched, secs))
    return runs


def unet_cpu_phase(torch, engine, _build, build_model, dev) -> dict:
    """``unet`` at 448^2 and ``unet_simam_256`` at 256^2, batch 1, the same
    weights (from SEED) and disc batch on the card and on the CPU, TF32 off.
    In float32: the eval logits (running statistics), then one Adam step:
    its loss, Dice and IoU and the running statistics it leaves, each within
    TOL_UNET x max(1, max|CPU|); its largest gradient gap is printed, not
    held (a ReLU input within rounding of 0 that takes the other side on one
    device moves the gradients upstream of it by a few % of their max).  In
    float64 on both sides (``Tensor.float`` widened for the step, as the
    card tests do), where no such flip happens: every gradient within
    TOL_UNET_GRAD x its own max|g| (the conv biases before a BatchNorm
    against their weight's).  The card's steps launch no kernel of the
    port."""
    phase("the UNet family: the card against the CPU (batch 1, float32 and float64, TF32 off)")
    out = {}
    for name, img in (("unet", UNET_IMG), ("unet_simam_256", 256)):
        cpu = build_model(name, device="cpu", seed=SEED)
        card = copy.deepcopy(cpu).to(dev)
        images, masks = disc_arrays(img, 1)
        x = torch.from_numpy(images).float() / 255.0
        with torch.no_grad():
            want = cpu(x)
            got = card(x.to(dev)).cpu()
        logit_gap = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        (m_card, g_card, b_card, launched, s_card), (m_cpu, g_cpu, b_cpu, _, s_cpu) = \
            unet_step_pair(torch, engine, _build, (card, cpu), images, masks)
        metric_gap = max(abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k])) for k in m_cpu)
        grad_name, grad_gap = max(((n, float((g_card[n] - g).abs().max())
                                    / max(1.0, float(g.abs().max())))
                                   for n, g in g_cpu.items()), key=lambda t: t[1])
        stat_gap = max(float((b_card[n].double() - b.double()).abs().max())
                       / max(1.0, float(b.double().abs().max())) for n, b in b_cpu.items())
        log(f"{name}, {img}^2, batch 1, float32: eval logits gap {logit_gap:.3e}; step metrics "
            f"card {m_card} vs CPU {m_cpu}, largest gap {metric_gap:.3e}; running statistics "
            f"gap {stat_gap:.3e} (each x max(1, max|CPU|), tol {TOL_UNET:g}); largest gradient "
            f"gap {grad_gap:.3e} ({grad_name}) over {len(g_cpu)} parameters (x max(1, "
            f"max|CPU|), a record, not held); launches {launched or 'none'}; a step "
            f"{s_card:.2f} s on the card (first), {s_cpu:.2f} s on the CPU")
        require(not launched, f"{name}: the step launched {launched}")
        for what, gap in (("eval logits", logit_gap), ("step metrics", metric_gap),
                          ("running statistics", stat_gap)):
            require(gap <= TOL_UNET, f"{name}: {what}, card vs CPU: {gap:.3e}")
        del cpu, card

        wide = build_model(name, device="cpu", seed=SEED).double()
        wide.dtype = torch.float64
        narrow = torch.Tensor.float
        torch.Tensor.float = torch.Tensor.double
        try:
            (_, w_card, _, w_launched, w_s_card), (_, w_cpu, _, _, w_s_cpu) = unet_step_pair(
                torch, engine, _build, (copy.deepcopy(wide).to(dev), wide), images, masks)
        finally:
            torch.Tensor.float = narrow
        wide_gaps = {}
        for n, g in w_cpu.items():
            scale = w_cpu[n[:-4] + "weight"] if n.endswith(UNET_NOISE_BIASES) else g
            wide_gaps[n] = float((w_card[n] - g).abs().max()) / max(float(scale.abs().max()),
                                                                    1e-300)
        wide_name = max(wide_gaps, key=wide_gaps.get)
        log(f"{name}, float64: largest gradient gap {wide_gaps[wide_name]:.3e} ({wide_name}) x "
            f"its own max|g| over {len(w_cpu)} parameters (tol {TOL_UNET_GRAD:g}); launches "
            f"{w_launched or 'none'}; a step {w_s_card:.2f} s on the card, {w_s_cpu:.2f} s on "
            f"the CPU")
        require(not w_launched, f"{name}: the float64 step launched {w_launched}")
        for n, gap in wide_gaps.items():
            require(gap <= TOL_UNET_GRAD, f"{name}: float64 gradient of {n}, card vs CPU: "
                    f"{gap:.3e} x its max|g|")
        out[name] = dict(img=img, logit_gap=logit_gap, metric_gap=metric_gap,
                         grad_gap_f32=grad_gap, grad_gap_f64=wide_gaps[wide_name],
                         stats_gap=stat_gap, card=m_card, cpu=m_cpu)
        del wide
    torch.cuda.empty_cache()
    return out


def unet_timing_phase(torch, engine, _build, build_model, train_configs, dev,
                      default_tf32) -> dict:
    """The full-width steps: ``unet`` (448^2, batch 4) with cuDNN's TF32 off
    and on, ``unet_simam_256`` (256^2, batch 4) with it off, 3 warm-up and
    10 timed steps each (host ms, device ms, peak memory, no launch); the
    largest logit gap between the two settings; then ``Server`` over
    ``unet`` at the buckets 1/2/4/8 with TF32 off and on."""
    from cswin_simam_unet_tpu_torch.serving import Server
    runs = {}
    unet = build_model("unet", device=dev, seed=SEED)
    for label, tf32 in (("unet, TF32 off", False), ("unet, TF32 on", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            runs[label] = train_phase(torch, engine, _build, label, unet, train_configs["unet"],
                                      {}, dev, {}, img=UNET_IMG, device_time=True)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    images_d, _ = disc_batch(torch, UNET_IMG, train_configs["unet"].batch_size, dev)
    x = images_d.float() / 255.0
    with torch.no_grad():
        off = unet(x)
        torch.backends.cudnn.allow_tf32 = True
        try:
            on = unet(x)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    tf32_gap = float((on - off).abs().max())
    log(f"unet logits, cuDNN TF32 on vs off (batch 4, eval): largest gap {tf32_gap:.3e} "
        f"(max|logit| {float(off.abs().max()):.3f}); torch's defaults in a fresh process, "
        f"which the CLI keeps: cudnn.allow_tf32={default_tf32['cudnn']}, "
        f"cuda.matmul.allow_tf32={default_tf32['matmul']}")
    simam = build_model("unet_simam_256", device=dev, seed=SEED)
    runs["unet_simam_256, TF32 off"] = train_phase(
        torch, engine, _build, "unet_simam_256, TF32 off", simam, train_configs["unet_simam_256"],
        {}, dev, {}, img=256, device_time=True)
    del simam

    phase(f"serving unet at {UNET_IMG}^2, float32, cuDNN TF32 off and on: requests of 1, 2, "
          f"4 and 8")
    server = Server(unet)
    images, _ = disc_arrays(UNET_IMG, 8)
    serve = {}
    _build.reset_launches()
    for label, tf32 in (("TF32 off", False), ("TF32 on", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            serve[label] = {}
            for n in (1, 2, 4, 8):
                server(images[:n])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SERVE_REPEATS):
                    probs = server(images[:n])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / SERVE_REPEATS * 1e3
                require(tuple(probs.shape) == (n, UNET_IMG, UNET_IMG, 1)
                        and bool(torch.isfinite(probs).all())
                        and 0.0 <= float(probs.min()) <= float(probs.max()) <= 1.0,
                        f"unet serving: request of {n}")
                serve[label][n] = ms
        finally:
            torch.backends.cudnn.allow_tf32 = False
        log(f"unet requests, {label}, ms (host clock, mean of {SERVE_REPEATS} after a warm-up, "
            "synchronize at both ends): " + ", ".join(
                f"{n}: {ms:.2f} ({n * 1e3 / ms:.1f} images/s)" for n, ms in serve[label].items()))
    launched = {k: n for k, n in _build.LAUNCHES.items() if n}
    log(f"unet serving launches: {launched or 'none'}")
    require(not launched, f"unet serving launched {launched}")
    del unet, server
    torch.cuda.empty_cache()
    return dict(steps=runs, tf32_logit_gap=tf32_gap, default_tf32=default_tf32,
                serving_ms=serve)


def unet_fit_phase(torch, engine, _build, build_model, train_configs, decoders, dev) -> dict:
    """``fit`` of ``unet`` (448^2, batch 4, Adam, augmented) for 2 epochs
    from the 24 JPEG pairs (or in memory where no decoder was found), with a
    ``CheckpointStore``, no kernel launched; then a fresh model and
    optimizer restore epoch 1 and train epoch 2 (cuDNN deterministic): the
    parameters and the BatchNorm buffers within TOL_RESUME of the unbroken
    run, the history within TOL_RESUME_HISTORY, the schedule the same."""
    from cswin_simam_unet_tpu_torch.data import (AugmentConfig, DataLoader,
                                                 SegmentationDataSource, train_test_indices)
    from cswin_simam_unet_tpu_torch.train.checkpoint import CheckpointStore
    from cswin_simam_unet_tpu_torch.train.schedule import make_plateau_scheduler
    tcfg = train_configs["unet"]
    files = decoders["native"] or decoders["cv2"] or decoders["pil"]
    phase(f"unet fit from {'files' if files else 'memory (no JPEG decoder)'}: {UNET_IMG}^2, "
          f"batch {tcfg.batch_size}, augmented, checkpointed, resumed")
    if files:
        source = SegmentationDataSource(os.path.join(DATA_DIR, "images"),
                                        os.path.join(DATA_DIR, "masks"), (UNET_IMG, UNET_IMG))
    else:
        source = MemorySource(24, UNET_IMG)
    train_idx, test_idx = train_test_indices(len(source), tcfg.test_split, tcfg.seed)

    def loaders():
        return (DataLoader(source, train_idx, tcfg.batch_size, shuffle=True, seed=tcfg.seed),
                DataLoader(source, test_idx, tcfg.batch_size, shuffle=False))

    def fresh(seed):
        net = build_model("unet", device=dev, seed=seed)
        opt = engine.make_optimizer(tcfg.optimizer, tcfg.learning_rate, tcfg.weight_decay,
                                    net.parameters())
        return net, opt, make_plateau_scheduler(opt, tcfg.plateau_factor, tcfg.plateau_patience,
                                                tcfg.plateau_min_lr)

    workdir = tempfile.mkdtemp(prefix="chip_smoke_unet_")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        store = CheckpointStore(os.path.join(workdir, "ck"))
        cfg = engine.FitConfig(num_epochs=2, augment=AugmentConfig(), seed=SEED, verbose=False,
                               checkpoint_manager=store)
        net, opt, sched = fresh(SEED)
        train, test = loaders()
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history, step = engine.fit(net, opt, train, test, cfg, scheduler=sched)
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t0) / 2 * 1e3
        launched = {k: n for k, n in _build.LAUNCHES.items() if n}
        require(not launched, f"unet fit launched {launched}")
        require(store.all_epochs() == [1, 2], f"unet checkpoints {store.all_epochs()}")
        for key, series in history.items():
            require(len(series) == 2 and all(math.isfinite(v) for v in series),
                    f"unet history {key}: {series}")
        ck_mib = os.path.getsize(os.path.join(store.directory, "epoch_2.pt")) / 2 ** 20
        log(f"unet fit: {epoch_ms:.1f} ms per epoch ({math.ceil(len(train_idx) / tcfg.batch_size)}"
            f" training and {len(test)} test batches, checkpointed every epoch, {ck_mib:.1f} MiB "
            f"each; host clock); history {json.dumps(history)}")

        net2, opt2, sched2 = fresh(SEED + 7)
        sched_state, hist2, epoch, step2 = store.restore(net2, opt2, epoch=1)
        sched2.load_state_dict(sched_state)
        train, test = loaders()
        hist2, step2 = engine.fit(net2, opt2, train, test, cfg, history=hist2, scheduler=sched2,
                                  start_epoch=epoch, global_step=step2)
        torch.cuda.synchronize()
        gaps = {n: float((a.double() - b.double()).abs().max()) for (n, a), b in
                zip(net.state_dict().items(), net2.state_dict().values())}
        param_names = {n for n, _ in net.named_parameters()}
        param_gap = max(g for n, g in gaps.items() if n in param_names)
        buffer_gap = max(g for n, g in gaps.items() if n not in param_names)
        hist_gap = max(abs(a - b) for k in hist2 for a, b in zip(hist2[k], history[k]))
        want_sched, got_sched = sched.state_dict(), sched2.state_dict()
        sched_diff = sorted(k for k in want_sched if k != "best"
                            and want_sched[k] != got_sched.get(k))
        best_gap = abs(want_sched["best"] - got_sched["best"])
        log(f"unet resumed from epoch 1: global step {step2} vs {step}; largest parameter gap "
            f"{param_gap:.3e}, BatchNorm buffer gap {buffer_gap:.3e} (tol {TOL_RESUME:g}; "
            f"bit-equal: {param_gap == buffer_gap == 0.0}); history gap {hist_gap:.3e} (tol "
            f"{TOL_RESUME_HISTORY:g}); schedule fields that differ: {sched_diff or 'none'}")
        require(step2 == step, "unet resumed fit: steps")
        require(max(param_gap, buffer_gap) <= TOL_RESUME,
                f"unet resumed fit: parameter gap {param_gap:.3e}, buffer gap {buffer_gap:.3e}")
        require(hist_gap <= TOL_RESUME_HISTORY, f"unet resumed fit: history gap {hist_gap:.3e}")
        require(not sched_diff and best_gap <= TOL_RESUME_HISTORY, "unet resumed fit: schedule")
        out = dict(from_files=bool(files), epoch_ms_checkpointed=epoch_ms, checkpoint_mib=ck_mib,
                   resume_param_gap=param_gap, resume_buffer_gap=buffer_gap,
                   resume_history_gap=hist_gap)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def unet_cli_phase(torch, build_model, decoders, dev) -> dict:
    """The CLI as child processes at ``unet`` (448^2, its default config),
    with torch's default numerics: ``train --epochs 2``, ``evaluate`` of the
    best weights on the test split against the history's best epoch,
    ``predict`` of the 24 images, ``export-torch`` of the final weights,
    whose ``.pth`` loads strictly into a fresh UNet and equals them."""
    import re
    from cswin_simam_unet_tpu_torch.compat.io import load_state_dict_file, load_state_dict_strict
    phase("the CLI at unet: train, evaluate, predict, export-torch")
    if not (decoders["native"] or decoders["cv2"] or decoders["pil"]):
        log("no JPEG decoder on this machine: the CLI reads JPEG files only; not run")
        return dict(ran=False)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_unet_cli_")
    try:
        dirs = ["--image-dir", os.path.join(DATA_DIR, "images"),
                "--mask-dir", os.path.join(DATA_DIR, "masks")]
        out, secs = {}, {}
        t0 = time.perf_counter()
        log_train = cli(["train", "--config", "unet", "--no-progress", *dirs, "--output-dir",
                         workdir, "--epochs", "2"], "train --config unet --epochs 2")
        secs["train"] = time.perf_counter() - t0
        require("Epoch [2/2]" in log_train and "params: 31043521" in log_train,
                "cli train --config unet")
        ckpt = os.path.join(workdir, "unet_checkpoints")
        with open(os.path.join(ckpt, "meta.json")) as f:
            best = json.load(f)["best_epoch"]
        history = torch.load(os.path.join(ckpt, "epoch_2.pt"), map_location="cpu",
                             weights_only=True)["history"]
        t0 = time.perf_counter()
        log_eval = cli(["evaluate", "--config", "unet", *dirs, "--weights",
                        os.path.join(ckpt, "best_weights.pth"), "--split", "test"], "evaluate")
        secs["evaluate"] = time.perf_counter() - t0
        m = re.search(r"Loss: (\S+), Dice: (\S+), IoU: (\S+)", log_eval)
        require(m is not None, f"cli evaluate printed {log_eval!r}")
        got = dict(zip(("loss", "dice", "iou"), map(float, m.groups())))
        gaps = {k: abs(v - history[f"test_{k}"][best - 1]) for k, v in got.items()}
        log(f"  evaluate of the best epoch ({best}): {got}; gaps to the history "
            + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()) + f" (tol {TOL_CLI_EVAL:g})")
        require(all(g <= TOL_CLI_EVAL for g in gaps.values()), "cli evaluate vs history")
        out.update(ran=True, best_epoch=best, evaluate=got, evaluate_gaps=gaps)
        if decoders["cv2"] or decoders["pil"]:
            pred = os.path.join(workdir, "pred")
            t0 = time.perf_counter()
            log_pred = cli(["predict", "--config", "unet", "--image-dir", dirs[1], "--weights",
                            ckpt, "--output-dir", pred], "predict")
            secs["predict"] = time.perf_counter() - t0
            n = len([p for p in os.listdir(pred) if p.endswith("_mask.png")])
            require(n == 24 and "Wrote 24 masks" in log_pred, f"cli predict wrote {n} masks")
            out["predicted_masks"] = n
        final = os.path.join(workdir, "unet_final_weights.pth")
        pth = os.path.join(workdir, "unet.pth")
        t0 = time.perf_counter()
        log_export = cli(["export-torch", "--config", "unet", "--weights", final, "--output",
                          pth], "export-torch")
        secs["export-torch"] = time.perf_counter() - t0
        require("(136 tensors)" in log_export, f"cli export-torch printed {log_export!r}")
        fresh = build_model("unet", device=dev, seed=SEED + 9)
        load_state_dict_strict(fresh, load_state_dict_file(pth), source=pth)
        saved = load_state_dict_file(final)
        require(all(torch.equal(v.cpu(), saved[k]) for k, v in fresh.state_dict().items()),
                "the exported .pth differs from the final weights")
        log(f"  exported {pth}: 136 tensors, loaded strictly into a fresh UNet on the card, "
            f"equal to the final weights; seconds: {secs}")
        out["seconds"] = secs
        del fresh
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr, flush=True)
        return 1
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    import torch.nn.functional as F
    from cswin_simam_unet_tpu_torch import _build
    from cswin_simam_unet_tpu_torch.configs import NO_DROPS, TRAIN_CONFIGS, build_model
    from cswin_simam_unet_tpu_torch.models.layers import CARAFE, LePEAttention
    from cswin_simam_unet_tpu_torch.ops import attention, carafe, carafe_head, dropout
    from cswin_simam_unet_tpu_torch.ops import carafe_kernels, flash_attention, stripe_attention
    from cswin_simam_unet_tpu_torch.ops.simam import pooled_stats
    from cswin_simam_unet_tpu_torch.serving import Server
    from cswin_simam_unet_tpu_torch.train import engine

    # torch's own defaults, which the CLI's processes keep
    default_tf32 = {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. environment ----
    phase("environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nvcc_version = run([_build._nvcc(), "--version"]).splitlines()[-1]
    log(f"nvcc: {nvcc_version}")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    log(f"nvidia-smi: {smi}")
    kind = torch.cuda.get_device_name(0)
    log(f"device 0: {kind}, {torch.cuda.device_count()} visible")

    # ---- 2. build ----
    phase("build")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    info = _build.build_info
    log(f"built {info['path']} in {build_s:.1f} s (nvcc {info['seconds']:.1f} s, "
        f"cached={info['cached']})")
    # -Xptxas -v: registers and spills of each kernel instantiation (the
    # mangled name carries the template arguments, e.g. ...ILi32ELb1E...)
    kernel, spill = "", ""
    for line in info.get("log", "").splitlines():
        if "Function properties for" in line:
            kernel = line.split("Function properties for")[-1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            log(f"  ptxas: {kernel[:80]}: {line.split(':', 1)[-1].strip()}; {spill}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    model = build_model("cswin_simam_512", device=dev, seed=SEED)
    model448 = build_model("cswinunet", device=dev, seed=SEED)
    table = {}

    # ---- 3. kernels against their plain versions ----
    phase("kernels vs plain versions (check at batch 2, time at batch 8, bf16)")

    # K-A at each attention geometry of the model, without and with dropout
    geoms = attention_geometries(model)
    ka = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err32=0.0,
              err16=0.0, bytes=0.0, flops=0.0, ms_drop=0.0, plain_ms_drop=0.0,
              library_ms_drop=0.0, err32_drop=0.0, err16_drop=0.0, rel32=0.0, rel16=0.0,
              rel32_drop=0.0, rel16_drop=0.0, device_ms=0.0, device_ms_drop=0.0,
              ms_fma_f32=0.0, ms_fma_f32_drop=0.0, exps=0.0, hashes=0.0)
    for (reso, Cb, heads, hsp, wsp), count in sorted(geoms.items()):
        L = reso * reso
        kw = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads)
        kwd = dict(kw, attn_drop=DROP, seed=DROP_SEED)

        def make(B, dtype, L=L, Cb=Cb):
            qkv = randn(B, L, 6 * Cb, scale=0.5, dtype=dtype)  # branch slices
            return (qkv[..., :Cb], qkv[..., 2 * Cb:3 * Cb], qkv[..., 4 * Cb:5 * Cb],
                    randn(3, 3, 1, Cb, scale=1 / 3, dtype=dtype))

        name = f"K-A reso {reso} window {hsp}x{wsp} Cb {Cb} heads {heads}"
        _build.reset_launches()
        e32, e16, r32, r16 = check_pair(
            name, torch,
            lambda q, k, v, w, kw=kw: stripe_attention.stripe_attention(q, k, v, w, **kw),
            lambda q, k, v, w, kw=kw: attention.stripe_attention(q, k, v, w, **kw), make,
            own=True)
        d32, d16, s32, s16 = check_pair(
            name + " dropout 0.3", torch,
            lambda q, k, v, w, kw=kwd: stripe_attention.stripe_attention(q, k, v, w, **kw),
            lambda q, k, v, w, kw=kwd: attention.stripe_attention(q, k, v, w, **kw), make,
            own=True)
        # the attention alone (zero LePE taps): the LePE's larger values would
        # hide an error in p from the own-scale check
        for label, kwa in (("", kw), (" dropout 0.3", kwd)):
            errs = check_pair(
                name + " without LePE" + label, torch,
                no_lepe(lambda q, k, v, w, kw=kwa: stripe_attention.stripe_attention(
                    q, k, v, w, **kw)),
                no_lepe(lambda q, k, v, w, kw=kwa: attention.stripe_attention(q, k, v, w, **kw)),
                make, own=True)
            for key, val in zip(("err32", "err16", "rel32", "rel16"), errs):
                key += "_drop" if label else ""
                ka[key] = max(ka[key], val)
        bodies = {n: c for n, c in _build.BODY_LAUNCHES.items() if c}
        require(bodies == {f"{stripe_attention.KERNEL}:{b}": 4 for b in ("mma", "fma")},
                f"{name}: K-A body launches {bodies}: float32 takes the CUDA-core body, bf16 "
                "the tensor-core body")
        q, k, v, w = make(TIME_BATCH, torch.bfloat16)
        ms = time_ms(torch, lambda: stripe_attention.stripe_attention(q, k, v, w, **kw))
        ms_drop = time_ms(torch, lambda: stripe_attention.stripe_attention(q, k, v, w, **kwd))
        ka_dev = device_ms(torch, lambda: stripe_attention.stripe_attention(q, k, v, w, **kw))
        ka_dev_drop = device_ms(torch, lambda: stripe_attention.stripe_attention(q, k, v, w,
                                                                                 **kwd))
        # the CUDA-core body on the same inputs in float32
        q32, k32, v32, w32 = (t.float() for t in (q, k, v, w))
        fma = time_ms(torch, lambda: stripe_attention.stripe_attention(q32, k32, v32, w32, **kw),
                      iters=3)
        fma_drop = time_ms(torch, lambda: stripe_attention.stripe_attention(
            q32, k32, v32, w32, **kwd), iters=3)
        del q32, k32, v32, w32
        plain = time_ms(torch, lambda: attention.stripe_attention(q, k, v, w, **kw), iters=3)
        plain_drop = time_ms(torch, lambda: attention.stripe_attention(q, k, v, w, **kwd),
                             iters=3)
        D, N = Cb // heads, hsp * wsp

        def win_heads(t):
            return attention.window_heads(t, hsp, wsp, reso, reso, heads).contiguous()

        qh, kh, vh = win_heads(q), win_heads(k), win_heads(v)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=D ** -0.5))
        lib_drop = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, dropout_p=DROP, scale=D ** -0.5))
        nbytes = 4 * TIME_BATCH * L * Cb * 2 + Cb * 9 * 4
        flops = (4 * N + 18) * TIME_BATCH * L * Cb
        b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
        log(f"    x{count}/forward: kernel {ms:.4f} ms (dropout 0.3: {ms_drop:.4f}; device "
            f"{ka_dev:.4f}, {ka_dev_drop:.4f})  CUDA-core body, f32: {fma:.4f} ({fma_drop:.4f})  "
            f"plain {plain:.4f} ms ({plain_drop:.4f})  sdpa {lib:.4f} ms ({lib_drop:.4f})  "
            f"bound {b_ms:.4f} ms")
        # two exps per score (the max-and-sum sweep, then p), one hash at rate 0.3
        scores = TIME_BATCH * (reso // hsp) * (reso // wsp) * heads * N * N
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bytes", nbytes), ("flops", flops), ("ms_drop", ms_drop),
                         ("plain_ms_drop", plain_drop), ("library_ms_drop", lib_drop),
                         ("device_ms", ka_dev), ("device_ms_drop", ka_dev_drop),
                         ("ms_fma_f32", fma),
                         ("ms_fma_f32_drop", fma_drop), ("exps", 2 * scores),
                         ("hashes", scores)):
            ka[key] += count * val
        for key, val in (("err32", e32), ("err16", e16), ("err32_drop", d32),
                         ("err16_drop", d16), ("rel32", r32), ("rel16", r16),
                         ("rel32_drop", s32), ("rel16_drop", s16)):
            ka[key] = max(ka[key], val)
    ka["bound_ms"], ka["bound_by"] = bound_ms(ka["bytes"], ka["flops"], "bfloat16")
    add_floor(torch, ka)
    log(f"  K-A per flagship forward (batch {TIME_BATCH}, bf16): {ka['ms']:.3f} / "
        f"{ka['ms_drop']:.3f} ms at rate 0 / {DROP} (device {ka['device_ms']:.3f} / "
        f"{ka['device_ms_drop']:.3f}); CUDA-core body in float32 {ka['ms_fma_f32']:.3f} / "
        f"{ka['ms_fma_f32_drop']:.3f}; bound {ka['bound_ms']:.4f} ({ka['bound_by']}); "
        + floor_text(ka))
    table["K-A"] = ka
    # the geometries of cswinunet (448^2, stripes 1, 2, 7, 7): with dropout
    geoms448 = attention_geometries(model448)
    for (reso, Cb, heads, hsp, wsp), _ in sorted(geoms448.items()):
        kwd = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=DROP,
                   seed=DROP_SEED)

        def make(B, dtype, L=reso * reso, Cb=Cb):
            qkv = randn(B, L, 6 * Cb, scale=0.5, dtype=dtype)
            return (qkv[..., :Cb], qkv[..., 2 * Cb:3 * Cb], qkv[..., 4 * Cb:5 * Cb],
                    randn(3, 3, 1, Cb, scale=1 / 3, dtype=dtype))

        errs = check_pair(
            f"K-A 448^2 reso {reso} window {hsp}x{wsp} Cb {Cb} heads {heads} dropout 0.3",
            torch, lambda q, k, v, w, kw=kwd: stripe_attention.stripe_attention(q, k, v, w, **kw),
            lambda q, k, v, w, kw=kwd: attention.stripe_attention(q, k, v, w, **kw), make,
            own=True)
        for key, val in zip(("err32_drop", "err16_drop", "rel32_drop", "rel16_drop"), errs):
            ka[key] = max(ka[key], val)
    # the keep rate read back from K-A: q = k = 0, v = 1, no LePE
    zeros = torch.zeros(TIME_BATCH, 128 * 128, 32, device=dev)
    out = stripe_attention.stripe_attention(
        zeros, zeros, torch.ones_like(zeros), torch.zeros(3, 3, 1, 32, device=dev), H=128,
        W=128, hsp=128, wsp=1, num_heads=1, attn_drop=DROP, seed=DROP_SEED)
    n_scores = TIME_BATCH * 128 ** 3
    p_keep = 1 - dropout.u32_threshold(DROP) / 2 ** 32
    keep_rate = float(out[..., 0].double().mean()) * (1 - DROP)
    sigma = (p_keep * (1 - p_keep) / n_scores) ** 0.5
    log(f"  K-A keep rate at 0.3 read back from the kernel: {keep_rate:.6f} over "
        f"{n_scores} scores (expected {p_keep:.6f}, 4 sigma {4 * sigma:.2e})")
    require(abs(keep_rate - p_keep) <= 4 * sigma, f"K-A keep rate {keep_rate}")
    ka["keep_rate"] = keep_rate
    del zeros, out

    # K-C at the three decoder CARAFEs, each output also at its own scale
    kc = dict(ms=0.0, plain_ms=0.0, device_ms=0.0, err32=0.0, err16=0.0, own32=0.0,
              own16=0.0, bytes=0.0, flops=0.0)
    ups = [m for n, m in model.named_modules()
           if isinstance(m, CARAFE) and n != "upsample1"]

    def decoder_carafes(img):
        """(reso, C, S) of the three decoder CARAFEs of a model at img^2."""
        return [(img // 4 // 2 ** (len(ups) - i), mod.out.weight.shape[0], mod.up_factor)
                for i, mod in enumerate(ups)]

    for reso, C, S in decoder_carafes(IMG):
        def make(B, dtype, reso=reso, C=C, S=S):
            return randn(B, reso, reso, C, dtype=dtype), randn(B, reso, reso, 9 * S * S,
                                                                dtype=dtype)

        e32, e16, rel32, rel16 = check_pair(
            f"K-C x ({reso},{reso},{C}) S {S}", torch,
            lambda x, e, S=S: carafe_kernels.carafe_flat(x, e, S),
            lambda x, e, S=S: carafe.carafe_flat(x, e, S), make, own=True)
        x, e = make(TIME_BATCH, torch.bfloat16)
        ms = time_ms(torch, lambda: carafe_kernels.carafe_flat(x, e, S))
        dms = device_ms(torch, lambda: carafe_kernels.carafe_flat(x, e, S))
        plain = time_ms(torch, lambda: carafe.carafe_flat(x, e, S), iters=3)
        nbytes = (x.numel() + e.numel() + x.numel() * S * S) * 2
        flops = 2 * 9 * x.numel() * S * S
        b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
        log(f"    x1/forward: kernel {ms:.4f} ms (device {dms:.4f})  plain {plain:.4f} ms  "
            f"bound {b_ms:.4f} ms")
        for key, val in (("ms", ms), ("device_ms", dms), ("plain_ms", plain),
                         ("bytes", nbytes), ("flops", flops)):
            kc[key] += val
        for key, val in (("err32", e32), ("err16", e16), ("own32", rel32), ("own16", rel16)):
            kc[key] = max(kc[key], val)
    kc["bound_ms"], kc["bound_by"] = bound_ms(kc["bytes"], kc["flops"], "bfloat16")
    kc["library_ms"] = None
    table["K-C"] = kc

    def carafe_device_ms(label, fn, img, B, dtype):
        """Device ms of one call of fn(x, enc, dout, S) at each decoder CARAFE
        of a model at img^2, batch B, summed over the three (the byte bound
        is logged beside it)."""
        total, nbytes = 0.0, 0.0
        for reso, C, S in decoder_carafes(img):
            x = randn(B, reso, reso, C, dtype=dtype)
            e = randn(B, reso, reso, 9 * S * S, dtype=dtype)
            d = randn(B, reso, reso, S * S * C, dtype=dtype)
            total += device_ms(torch, lambda: fn(x, e, d, S))
            fwd = (x.numel() + e.numel() + d.numel()) * x.element_size()
            nbytes += fwd if label == "K-C" else fwd + (x.numel() + e.numel()) * x.element_size()
            del x, e, d
        log(f"    {label}, the three decoder CARAFEs at {img}^2 (batch {B}, {dtype}): device "
            f"{total:.4f} ms (bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f})")
        return total

    # at the 2048^2 path (batch 1, bf16) and cswinunet's (448^2, batch 2, float32)
    for label, B, img, dtype in (("2048", 1, IMG2048, torch.bfloat16),
                                 ("448", TRAIN_CONFIGS["cswinunet"].batch_size, IMG448,
                                  torch.float32)):
        kc[f"device_ms_{label}"] = carafe_device_ms(
            "K-C", lambda x, e, d, S: carafe_kernels.carafe_flat(x, e, S), img, B, dtype)

    # K-H1 and K-H2 at the final head: x (B,128,128,64), S 4, one class
    r0, E, S = IMG // 4, model.output.weight.shape[1], 4
    S_HEAD = S
    G = S * S
    F_cls = model.output.weight.shape[0]

    def make_h1(B, dtype):
        return (randn(B, r0, r0, E, dtype=dtype), randn(B, r0, r0, 9 * G, dtype=dtype),
                randn(E, scale=0.1, dtype=dtype))

    def h1_kernel(x, e, b):
        return carafe_head.carafe_biased_moments(x, e, b, S)[0]

    def h1_plain(x, e, b):
        return carafe.carafe_flat(x, e, S) + b.repeat(G)

    e32, e16, rel32, rel16 = check_pair("K-H1 x (128,128,64) S 4", torch, h1_kernel, h1_plain,
                                        make_h1, own=True)
    # the moments: K-H1's per-channel block sums (B, chunks, C), pooled, against
    # torch sums of the kernel's own map
    for dtype in (torch.float32, torch.bfloat16):
        x, e, b = make_h1(2, dtype)
        fb, s1, s2 = carafe_head.carafe_biased_moments(x, e, b, S)
        mu, v = pooled_stats(s1.sum(1), s2.sum(1), r0 * r0 * G, 1)
        fbf = fb.float()
        mu_p, v_p = pooled_stats(fbf.sum((1, 2)), (fbf * fbf).sum((1, 2)), r0 * r0 * G, G)
        rel = max(float(((mu - mu_p).abs() / (1 + mu_p.abs())).max()),
                  float(((v - v_p).abs() / (1 + v_p.abs())).max()))
        log(f"  K-H1 moments {dtype}: max rel err {rel:.3e} (tol {TOL_STATS:g})")
        require(rel <= TOL_STATS, f"K-H1 moments error {rel} > {TOL_STATS}")
    def h1_bytes(x, e):
        # x and enc read, the biased map written, bias and the (B, C) moments
        return ((x.numel() + e.numel() + x.numel() * G + E) * x.element_size()
                + 2 * x.shape[0] * E * 4)

    x, e, b = make_h1(TIME_BATCH, torch.bfloat16)
    ms = time_ms(torch, lambda: carafe_head.carafe_biased_moments(x, e, b, S))
    dms = device_ms(torch, lambda: carafe_head.carafe_biased_moments(x, e, b, S))
    plain = time_ms(torch, lambda: h1_plain(x, e, b), iters=3)
    flops = 2 * 9 * x.numel() * G + 3 * x.numel() * G
    b_ms, b_by = bound_ms(h1_bytes(x, e), flops, "bfloat16")
    log(f"    x1/forward: kernel {ms:.4f} ms (device {dms:.4f})  plain {plain:.4f} ms  "
        f"bound {b_ms:.4f} ms; "
        f"{head_floor_text(torch, x.numel() * G, x.numel() // E, G, 'K-H1')}")
    table["K-H1"] = dict(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, err32=e32, err16=e16, own32=rel32, own16=rel16)

    def make_h2(B, dtype):
        fb = randn(B, r0, r0, G * E, dtype=dtype)
        return fb, randn(E, F_cls, scale=E ** -0.5, dtype=dtype)

    def h2_kernel(fb, w):
        fbf = fb.float()
        mu, v = pooled_stats(fbf.sum((1, 2)), (fbf * fbf).sum((1, 2)), r0 * r0 * G, G)
        return carafe_head.simam_head_flat(fb, mu, v, w, G)

    def h2_plain(fb, w):
        return carafe_head.head_reference(fb, torch.zeros(E, device=dev), w, G)

    e32, e16, rel32, rel16 = check_pair("K-H2 fb (128,128,1024) G 16", torch, h2_kernel,
                                        h2_plain, make_h2, own=True)

    def h2_bytes(fb):
        # the map read, the logits written, the (B, C) statistics and w
        return (fb.numel() + fb.numel() // E * F_cls + E * F_cls) * fb.element_size() \
            + 2 * fb.shape[0] * E * 4

    fb, w = make_h2(TIME_BATCH, torch.bfloat16)
    fbf = fb.float()
    mu, v = pooled_stats(fbf.sum((1, 2)), (fbf * fbf).sum((1, 2)), r0 * r0 * G, G)
    del fbf
    ms = time_ms(torch, lambda: carafe_head.simam_head_flat(fb, mu, v, w, G))
    dms = device_ms(torch, lambda: carafe_head.simam_head_flat(fb, mu, v, w, G))
    plain = time_ms(torch, lambda: h2_plain(fb, w), iters=3)
    flops = 2 * fb.numel() * F_cls + 6 * fb.numel()
    b_ms, b_by = bound_ms(h2_bytes(fb), flops, "bfloat16")
    log(f"    x1/forward: kernel {ms:.4f} ms (device {dms:.4f})  plain {plain:.4f} ms  "
        f"bound {b_ms:.4f} ms; {head_floor_text(torch, fb.numel(), 0, G, 'K-H2')}")
    table["K-H2"] = dict(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, err32=e32, err16=e16, own32=rel32, own16=rel16)
    del fb, x, e

    # K-H1 and K-H2 at the 2048^2 head (cswin_simam_2048: batch 1, bf16) and
    # at cswinunet's (448^2, batch 2, float32, no SimAM): device time, the
    # wrappers' torch glue included
    r2k = IMG2048 // 4
    for label, B, r, dtype, gate in (("2048", 1, r2k, torch.bfloat16, True),
                                     ("448", TRAIN_CONFIGS["cswinunet"].batch_size,
                                      IMG448 // 4, torch.float32, False)):
        x = randn(B, r, r, E, dtype=dtype)
        e = randn(B, r, r, 9 * G, dtype=dtype)
        b = randn(E, scale=0.1, dtype=dtype)
        w = randn(E, F_cls, scale=E ** -0.5, dtype=dtype)
        fb, _, _ = carafe_head.carafe_biased_moments(x, e, b, S, gate)
        mu = v = None
        if gate:
            fbf = fb.float()
            mu, v = pooled_stats(fbf.sum((1, 2)), (fbf * fbf).sum((1, 2)), r * r * G, G)
            del fbf
        h1 = device_ms(torch, lambda: carafe_head.carafe_biased_moments(x, e, b, S, gate))
        h2 = device_ms(torch, lambda: carafe_head.simam_head_flat(fb, mu, v, w, G, gate=gate))
        log(f"    {label}^2 head (batch {B}, {dtype}, gate {gate}): K-H1 device {h1:.4f} ms "
            f"(bound {bound_ms(h1_bytes(x, e), 0, 'bfloat16')[0]:.4f}), K-H2 device "
            f"{h2:.4f} ms (bound {bound_ms(h2_bytes(fb), 0, 'bfloat16')[0]:.4f})"
            + (f"; {head_floor_text(torch, fb.numel(), x.numel() // E, G, 'K-H1')}; "
               f"{head_floor_text(torch, fb.numel(), 0, G, 'K-H2')}" if gate else ""))
        table["K-H1"][f"device_ms_{label}"] = h1
        table["K-H2"][f"device_ms_{label}"] = h2
        del x, e, fb
    torch.cuda.empty_cache()

    # ---- 4. backward kernels against their plain versions ----
    phase("backward kernels vs plain versions (check at batch 2, time at batch 8, bf16)")

    # K-A' at each attention geometry of the model, without and with dropout
    kab = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, err32=0.0, err16=0.0, abs32=0.0,
               bytes=0.0, flops=0.0, ms_drop=0.0, plain_ms_drop=0.0, library_ms_drop=0.0,
               err32_drop=0.0, err16_drop=0.0, abs32_drop=0.0, rel32=0.0, rel16=0.0,
               rel32_drop=0.0, rel16_drop=0.0, device_ms=0.0, device_ms_drop=0.0,
               ms_fma_f32=0.0, ms_fma_f32_drop=0.0, library_device_ms=0.0,
               library_device_ms_drop=0.0, device_ms_dq=0.0, device_ms_dkv=0.0,
               device_ms_dkv_no_lepe=0.0, exps=0.0, hashes=0.0)

    def make_bwd(L, Cb):
        def make(B, dtype):
            qkv = randn(B, L, 6 * Cb, scale=0.5, dtype=dtype)  # branch slices
            return (qkv[..., :Cb], qkv[..., 2 * Cb:3 * Cb], qkv[..., 4 * Cb:5 * Cb],
                    randn(3, 3, 1, Cb, scale=1 / 3, dtype=dtype), randn(B, L, Cb, dtype=dtype))
        return make

    def ka_bwd(q, k, v, w, g, **kw):
        """K-A' as the autograd Function runs it: from the L that K-A saves
        (the tensor-core body reads it, the CUDA-core body's K-A saves none)."""
        _, lse = stripe_attention.attention_fwd(q, k, v, w, **kw, with_lse=True)
        return stripe_attention.attention_bwd(q, k, v, w, g, **kw, lse=lse)

    def check_bwd(name, kw, make):
        return check_outputs(
            name, torch, lambda q, k, v, w, g: ka_bwd(q, k, v, w, g, **kw),
            lambda q, k, v, w, g: attention.stripe_attention_bwd_reference(
                q, k, v, w, g, **kw), make)

    def check_bwd_own(name, kw, make):
        """Every output against its own max|plain| too (dq, dk, dv are
        0.004-0.05 here, so the max(1, .) scale alone passed a dq at 0.9x),
        with the LePE and without it (zero taps: dv is then P^T dO alone,
        which the LePE's transpose hid)."""
        worst = [0.0] * 4
        for label, wrap in (("", lambda f: f), (" without LePE", no_lepe)):
            res = check_outputs_by_kernel(
                name + label, torch, wrap(lambda q, k, v, w, g: ka_bwd(q, k, v, w, g, **kw)),
                wrap(lambda q, k, v, w, g: attention.stripe_attention_bwd_reference(
                    q, k, v, w, g, **kw)), make, {"K-A'": [0, 1, 2, 3]}, scaled32=True,
                batch=2)["K-A'"]
            worst = [max(a, b) for a, b in zip(worst, res)]
        return worst

    def fold_bwd(errs, keys):
        for key, val in zip(keys, errs):
            kab[key] = max(kab[key], val)

    for (reso, Cb, heads, hsp, wsp), count in sorted(geoms.items()):
        L = reso * reso
        kw = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads)
        kwd = dict(kw, attn_drop=DROP, seed=DROP_SEED)
        make = make_bwd(L, Cb)
        name = f"K-A' reso {reso} window {hsp}x{wsp} Cb {Cb} heads {heads}"
        _build.reset_launches()
        e32, e16, a32 = check_bwd(name, kw, make)
        d32, d16, da32 = check_bwd(name + " dropout 0.3", kwd, make)
        fold_bwd((e32, e16, a32, d32, d16, da32),
                 ("err32", "err16", "abs32", "err32_drop", "err16_drop", "abs32_drop"))
        fold_bwd(check_bwd_own(name, kw, make)[2:], ("rel32", "rel16"))
        fold_bwd(check_bwd_own(name + " dropout 0.3", kwd, make)[2:],
                 ("rel32_drop", "rel16_drop"))
        bodies = {n: c for n, c in _build.BODY_LAUNCHES.items()
                  if c and n.startswith(stripe_attention.BWD_KERNEL)}
        require(bodies == {f"{stripe_attention.BWD_KERNEL}:{b}": 6 for b in ("mma", "fma")},
                f"{name}: K-A' body launches {bodies}: float32 takes the CUDA-core body, bf16 "
                "the tensor-core body")
        q, k, v, w, g = make(TIME_BATCH, torch.bfloat16)
        _, lse = stripe_attention.attention_fwd(q, k, v, w, **kw, with_lse=True)

        def kab_call(kw_):
            return lambda: stripe_attention.attention_bwd(q, k, v, w, g, **kw_, lse=lse)

        ms, ms_drop = time_ms(torch, kab_call(kw)), time_ms(torch, kab_call(kwd))
        dev_ms, dev_ms_drop = device_ms(torch, kab_call(kw)), device_ms(torch, kab_call(kwd))
        # where the device time goes, at rate 0: the two kernels apart (dq
        # sweeps the keys twice, for delta and for ds), and dk/dv also in
        # flash mode (no LePE transpose, no dw partial) on the same windows
        delta = flash_attention.kernel_dq(q, k, v, lse, g, **kw, mode="window")[1]
        dq_dev = device_ms(torch, lambda: flash_attention.kernel_dq(q, k, v, lse, g, **kw,
                                                                    mode="window"))
        dkv_dev = device_ms(torch, lambda: flash_attention.kernel_dkv(
            q, k, v, w, lse, delta, g, **kw, mode="window"))
        dkv_bare = device_ms(torch, lambda: flash_attention.kernel_dkv(
            q, k, v, None, lse, delta, g, **kw, mode="flash"))
        del delta
        # the CUDA-core body on the same inputs in float32
        q32, k32, v32, w32, g32 = (t.float() for t in (q, k, v, w, g))
        fma = time_ms(torch, lambda: stripe_attention.attention_bwd(q32, k32, v32, w32, g32,
                                                                    **kw), iters=3)
        fma_drop = time_ms(torch, lambda: stripe_attention.attention_bwd(q32, k32, v32, w32, g32,
                                                                         **kwd), iters=3)
        del q32, k32, v32, w32, g32
        plain = time_ms(torch, lambda: attention.stripe_attention_bwd_reference(
            q, k, v, w, g, **kw), iters=3)
        plain_drop = time_ms(torch, lambda: attention.stripe_attention_bwd_reference(
            q, k, v, w, g, **kwd), iters=3)
        D, N = Cb // heads, hsp * wsp

        def win_heads(t):
            return attention.window_heads(t, hsp, wsp, reso, reso, heads).contiguous()

        qh, kh, vh = (win_heads(t).requires_grad_() for t in (q, k, v))
        gh = win_heads(g)
        libs = []
        for p_drop in (0.0, DROP):
            # the SDPA call draws its dropout mask in the forward; its backward
            # is timed on that one graph, with host dispatch and on the device
            sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, dropout_p=p_drop,
                                                      scale=D ** -0.5)

            def sdpa_bwd(out=sdpa_out):
                return torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True)

            libs += [time_ms(torch, sdpa_bwd), device_ms(torch, sdpa_bwd)]
            del sdpa_out, sdpa_bwd
        lib, lib_dev, lib_drop, lib_dev_drop = libs
        del qh, kh, vh, gh
        nbytes = 7 * TIME_BATCH * L * Cb * 2 + Cb * 9 * 4 * 2
        flops = (10 * N + 36) * TIME_BATCH * L * Cb
        b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
        log(f"    x{count}/step: kernel {ms:.4f} ms (dropout 0.3: {ms_drop:.4f}; device "
            f"{dev_ms:.4f}, {dev_ms_drop:.4f}; at rate 0 dq {dq_dev:.4f}, dk/dv {dkv_dev:.4f}, "
            f"dk/dv without the LePE {dkv_bare:.4f})  CUDA-core body, f32: {fma:.4f} "
            f"({fma_drop:.4f})  plain {plain:.4f} ms ({plain_drop:.4f})  sdpa bwd {lib:.4f} ms "
            f"({lib_drop:.4f}; device {lib_dev:.4f}, {lib_dev_drop:.4f})  bound {b_ms:.4f} ms")
        # dq sweeps the keys twice (delta, then ds), dk/dv the queries once:
        # three exps per score; the hash in dq's first sweep and in dk/dv
        scores = TIME_BATCH * (reso // hsp) * (reso // wsp) * heads * N * N
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bytes", nbytes), ("flops", flops), ("ms_drop", ms_drop),
                         ("plain_ms_drop", plain_drop), ("library_ms_drop", lib_drop),
                         ("device_ms", dev_ms), ("device_ms_drop", dev_ms_drop),
                         ("device_ms_dq", dq_dev), ("device_ms_dkv", dkv_dev),
                         ("device_ms_dkv_no_lepe", dkv_bare),
                         ("ms_fma_f32", fma), ("ms_fma_f32_drop", fma_drop),
                         ("library_device_ms", lib_dev), ("library_device_ms_drop", lib_dev_drop),
                         ("exps", 3 * scores), ("hashes", 2 * scores)):
            kab[key] += count * val
        del lse
    kab["bound_ms"], kab["bound_by"] = bound_ms(kab["bytes"], kab["flops"], "bfloat16")
    add_floor(torch, kab)
    log(f"  K-A' per flagship step (batch {TIME_BATCH}, bf16): {kab['ms']:.3f} / "
        f"{kab['ms_drop']:.3f} ms at rate 0 / {DROP} (device {kab['device_ms']:.3f} / "
        f"{kab['device_ms_drop']:.3f}; at rate 0 dq {kab['device_ms_dq']:.3f}, dk/dv "
        f"{kab['device_ms_dkv']:.3f}, dk/dv without the LePE {kab['device_ms_dkv_no_lepe']:.3f}); "
        f"CUDA-core body in float32 {kab['ms_fma_f32']:.3f} / "
        f"{kab['ms_fma_f32_drop']:.3f}; SDPA backward {kab['library_ms']:.3f} / "
        f"{kab['library_ms_drop']:.3f} (device {kab['library_device_ms']:.3f} / "
        f"{kab['library_device_ms_drop']:.3f}); bound {kab['bound_ms']:.4f} ({kab['bound_by']}); "
        + floor_text(kab))
    for (reso, Cb, heads, hsp, wsp), _ in sorted(geoms448.items()):
        kwd = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=DROP,
                   seed=DROP_SEED)
        name = f"K-A' 448^2 reso {reso} window {hsp}x{wsp} Cb {Cb} heads {heads} dropout 0.3"
        fold_bwd(check_bwd(name, kwd, make_bwd(reso * reso, Cb)),
                 ("err32_drop", "err16_drop", "abs32_drop"))
        fold_bwd(check_bwd_own(name, kwd, make_bwd(reso * reso, Cb))[2:],
                 ("rel32_drop", "rel16_drop"))
    table["K-A'"] = kab

    # K-C' at the three decoder CARAFEs, dx and denc also at their own scale
    kcb = dict(ms=0.0, plain_ms=0.0, device_ms=0.0, err32=0.0, err16=0.0, abs32=0.0,
               bytes=0.0, flops=0.0)
    for reso, C, S in decoder_carafes(IMG):
        def make(B, dtype, reso=reso, C=C, S=S):
            return (randn(B, reso, reso, C, dtype=dtype),
                    randn(B, reso, reso, 9 * S * S, dtype=dtype),
                    randn(B, reso, reso, S * S * C, dtype=dtype))

        e32, e16, a32 = check_outputs(
            f"K-C' x ({reso},{reso},{C}) S {S}", torch,
            lambda x, e, d, S=S: carafe_kernels.carafe_flat_bwd(x, e, d, S),
            lambda x, e, d, S=S: carafe.carafe_bwd_reference(x, e, d, S), make, own=(0, 1))
        x, e, d = make(TIME_BATCH, torch.bfloat16)
        ms = time_ms(torch, lambda: carafe_kernels.carafe_flat_bwd(x, e, d, S))
        dms = device_ms(torch, lambda: carafe_kernels.carafe_flat_bwd(x, e, d, S))
        plain = time_ms(torch, lambda: carafe.carafe_bwd_reference(x, e, d, S), iters=3)
        nbytes = (2 * x.numel() + 2 * e.numel() + d.numel()) * 2
        flops = 6 * 9 * d.numel()
        b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
        log(f"    x1/step: kernel {ms:.4f} ms (device {dms:.4f})  plain {plain:.4f} ms  "
            f"bound {b_ms:.4f} ms")
        for key, val in (("ms", ms), ("device_ms", dms), ("plain_ms", plain),
                         ("bytes", nbytes), ("flops", flops)):
            kcb[key] += val
        kcb["err32"] = max(kcb["err32"], e32)
        kcb["err16"] = max(kcb["err16"], e16)
        kcb["abs32"] = max(kcb["abs32"], a32)
    kcb["bound_ms"], kcb["bound_by"] = bound_ms(kcb["bytes"], kcb["flops"], "bfloat16")
    kcb["library_ms"] = None
    for label, B, img, dtype in (("2048", 1, IMG2048, torch.bfloat16),
                                 ("448", TRAIN_CONFIGS["cswinunet"].batch_size, IMG448,
                                  torch.float32)):
        kcb[f"device_ms_{label}"] = carafe_device_ms(
            "K-C'", carafe_kernels.carafe_flat_bwd, img, B, dtype)
    table["K-C'"] = kcb

    # K3 and K4 at the final head: fb (B,128,128,1024), S 4, one class
    def make_head(B, dtype):
        fb = randn(B, r0, r0, G * E, dtype=dtype)
        fbf = fb.float()
        mu, v = pooled_stats(fbf.sum((1, 2)), (fbf * fbf).sum((1, 2)), r0 * r0 * G, G)
        return (fb, randn(B, r0, r0, G * F_cls, dtype=dtype), mu, v,
                randn(E, F_cls, scale=E ** -0.5))

    e32, e16, a32 = check_outputs(
        "K3 fb (128,128,1024) G 16", torch,
        lambda fb, dy, mu, v, w: carafe_head.head_bwd1(fb, dy, mu, v, w, G),
        lambda fb, dy, mu, v, w: carafe_head.head_bwd1_reference(fb, dy, mu, v, w, G),
        make_head, own=(0, 1, 2))
    fb, dy, mu, v, w = make_head(TIME_BATCH, torch.bfloat16)
    ms = time_ms(torch, lambda: carafe_head.head_bwd1(fb, dy, mu, v, w, G))
    dms = device_ms(torch, lambda: carafe_head.head_bwd1(fb, dy, mu, v, w, G))
    plain = time_ms(torch, lambda: carafe_head.head_bwd1_reference(fb, dy, mu, v, w, G),
                    iters=3)
    nbytes = (fb.numel() + dy.numel()) * 2 + 4 * TIME_BATCH * E * 4 + E * F_cls * 8
    flops = (16 + 4 * F_cls) * fb.numel()
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log(f"    x1/step: kernel {ms:.4f} ms (device {dms:.4f})  plain {plain:.4f} ms  "
        f"bound {b_ms:.4f} ms; {head_floor_text(torch, fb.numel(), fb.numel() // (G * E), G, 'K3')}")
    table["K3"] = dict(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, err32=e32, err16=e16, abs32=a32)
    del fb, dy

    def make_k4(B, dtype):
        fb, dy, mu, v, w = make_head(B, dtype)
        A, Bq, _ = carafe_head.head_bwd1_reference(fb.float(), dy.float(), mu, v, w, G)
        return (randn(B, r0, r0, E, dtype=dtype), randn(B, r0, r0, 9 * G, dtype=dtype),
                fb, dy, mu, v, A, Bq, w)

    e32, e16, a32 = check_outputs(
        "K4 x (128,128,64) S 4", torch,
        lambda *a: carafe_head.fused_head_bwd(*a, S_HEAD),
        lambda *a: carafe_head.fused_head_bwd_reference(*a, S_HEAD), make_k4, own=(0, 1, 2))
    # K4 where runs and strips do not divide the image: x (45, 77, 64), runs of
    # 16 rows (45 = 2 x 16 + 13) over strips of 8 columns (77 = 9 x 8 + 5)
    def make_k4_ragged(B, dtype):
        fb = randn(B, 45, 77, G * E, dtype=dtype)
        fbf = fb.float()
        mu, v = pooled_stats(fbf.sum((1, 2)), (fbf * fbf).sum((1, 2)), 45 * 77 * G, G)
        dy = randn(B, 45, 77, G * F_cls, dtype=dtype)
        w = randn(E, F_cls, scale=E ** -0.5)
        A, Bq, _ = carafe_head.head_bwd1_reference(fbf, dy.float(), mu, v, w, G)
        return (randn(B, 45, 77, E, dtype=dtype), randn(B, 45, 77, 9 * G, dtype=dtype),
                fb, dy, mu, v, A, Bq, w)

    for gate in (True, False):
        check_outputs(
            f"K4{'' if gate else ' no gate'} x (45,77,64) S 4, runs of 16 rows, strips of 8",
            torch, lambda *a, gate=gate: carafe_head.fused_head_bwd(*a, S_HEAD, gate=gate,
                                                                    tile=(16, 8)),
            lambda *a, gate=gate: carafe_head.fused_head_bwd_reference(*a, S_HEAD, gate=gate),
            make_k4_ragged, own=(0, 1, 2))
    args = make_k4(TIME_BATCH, torch.bfloat16)
    ms = time_ms(torch, lambda: carafe_head.fused_head_bwd(*args, S_HEAD))
    dms = device_ms(torch, lambda: carafe_head.fused_head_bwd(*args, S_HEAD))
    plain = time_ms(torch, lambda: carafe_head.fused_head_bwd_reference(*args, S_HEAD),
                    iters=3)
    x, e, fb, dy = args[:4]
    nbytes = k4_bytes(x, e, fb, dy, E, F_cls)
    flops = 6 * 9 * fb.numel() + 16 * fb.numel()
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log(f"    x1/step: kernel {ms:.4f} ms (device {dms:.4f})  plain {plain:.4f} ms  "
        f"bound {b_ms:.4f} ms; {head_floor_text(torch, fb.numel(), x.numel() // E, G, 'K4')}")
    table["K4"] = dict(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, err32=e32, err16=e16, abs32=a32)
    del args, x, e, fb, dy

    # K3 and K4 at the 2048^2 head (cswin_simam_2048: batch 1, x (1,512,512,64)), bf16,
    # device time only; A and B from K3
    r2k = IMG2048 // 4
    fb = randn(1, r2k, r2k, G * E, dtype=torch.bfloat16)
    fbf = fb.float()
    mu, v = pooled_stats(fbf.sum((1, 2)), (fbf * fbf).sum((1, 2)), r2k * r2k * G, G)
    del fbf
    dy = randn(1, r2k, r2k, G * F_cls, dtype=torch.bfloat16)
    w = randn(E, F_cls, scale=E ** -0.5)
    x = randn(1, r2k, r2k, E, dtype=torch.bfloat16)
    e = randn(1, r2k, r2k, 9 * G, dtype=torch.bfloat16)
    A, Bq, _ = carafe_head.head_bwd1(fb, dy, mu, v, w, G)
    k3_2k = device_ms(torch, lambda: carafe_head.head_bwd1(fb, dy, mu, v, w, G))
    k4_2k = device_ms(torch, lambda: carafe_head.fused_head_bwd(x, e, fb, dy, mu, v, A, Bq, w,
                                                                S_HEAD))
    nb3 = (fb.numel() + dy.numel()) * 2 + 4 * E * 4 + E * F_cls * 8
    nb4 = k4_bytes(x, e, fb, dy, E, F_cls)
    log(f"    2048^2 head (batch 1, bf16): K3 device {k3_2k:.4f} ms (bound "
        f"{bound_ms(nb3, 0, 'bfloat16')[0]:.4f}), K4 device {k4_2k:.4f} ms (bound "
        f"{bound_ms(nb4, 0, 'bfloat16')[0]:.4f}); "
        f"{head_floor_text(torch, fb.numel(), x.numel() // E, G, 'K4')}")
    table["K3"]["device_ms_2048"] = k3_2k
    table["K4"]["device_ms_2048"] = k4_2k
    del fb, dy, x, e, A, Bq
    torch.cuda.empty_cache()

    # K3 and K4 without the gate at cswinunet's head: fb (2,112,112,1024),
    # S 4, one class, float32 (its compute dtype), batch 2 (its batch)
    r448, B448 = IMG448 // 4, TRAIN_CONFIGS["cswinunet"].batch_size

    def make_ng(B, dtype):
        return (randn(B, r448, r448, G * E, dtype=dtype),
                randn(B, r448, r448, G * F_cls, dtype=dtype), randn(E, F_cls, scale=E ** -0.5))

    e32, e16, a32 = check_outputs(
        "K3 no gate fb (112,112,1024) G 16", torch,
        lambda fb, dy, w: carafe_head.head_bwd1(fb, dy, None, None, w, G, gate=False)[2:],
        lambda fb, dy, w: carafe_head.head_bwd1_reference(fb, dy, None, None, w, G,
                                                          gate=False)[2:], make_ng, own=(0,))
    fb, dy, w = make_ng(B448, torch.float32)
    ms = time_ms(torch, lambda: carafe_head.head_bwd1(fb, dy, None, None, w, G, gate=False))
    dms = device_ms(torch, lambda: carafe_head.head_bwd1(fb, dy, None, None, w, G, gate=False))
    plain = time_ms(torch, lambda: carafe_head.head_bwd1_reference(fb, dy, None, None, w, G,
                                                                   gate=False), iters=3)
    nbytes = (fb.numel() + dy.numel()) * 4 + E * F_cls * 4
    flops = 2 * F_cls * fb.numel()
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    log(f"    x1/step (batch {B448}, float32): kernel {ms:.4f} ms (device {dms:.4f})  "
        f"plain {plain:.4f} ms  bound {b_ms:.4f} ms")
    table["K3 no gate"] = dict(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                               library_ms=None, err32=e32, err16=e16, abs32=a32)

    def make_k4ng(B, dtype):
        fb, dy, w = make_ng(B, dtype)
        return (randn(B, r448, r448, E, dtype=dtype), randn(B, r448, r448, 9 * G, dtype=dtype),
                fb, dy, w)

    def k4ng(x, e, fb, dy, w):
        return carafe_head.fused_head_bwd(x, e, fb, dy, None, None, None, None, w, S_HEAD,
                                          gate=False)

    def k4ng_plain(x, e, fb, dy, w):
        return carafe_head.fused_head_bwd_reference(x, e, fb, dy, None, None, None, None, w,
                                                    S_HEAD, gate=False)

    e32, e16, a32 = check_outputs("K4 no gate x (112,112,64) S 4", torch, k4ng, k4ng_plain,
                                  make_k4ng, own=(0, 1, 2))
    args = make_k4ng(B448, torch.float32)
    ms = time_ms(torch, lambda: k4ng(*args))
    dms = device_ms(torch, lambda: k4ng(*args))
    plain = time_ms(torch, lambda: k4ng_plain(*args), iters=3)
    x, e, _, dy, _ = args
    nbytes = (2 * x.numel() + 2 * e.numel() + dy.numel()) * 4 + E * F_cls * 4 + E * 4
    flops = 6 * 9 * x.numel() * G + 2 * F_cls * x.numel() * G
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    log(f"    x1/step (batch {B448}, float32): kernel {ms:.4f} ms (device {dms:.4f})  "
        f"plain {plain:.4f} ms  bound {b_ms:.4f} ms")
    table["K4 no gate"] = dict(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                               library_ms=None, err32=e32, err16=e16, abs32=a32)
    del args, x, e, fb, dy
    torch.cuda.empty_cache()

    # ---- 4b. long windows: the flash family ----
    phase("long-window kernels vs plain versions (windows of cswin_simam_1024 and _2048)")
    model2048 = build_model("cswin_simam_2048", device=dev, seed=SEED)
    geoms2048 = attention_geometries(model2048)
    geoms_long = set(geoms2048) | set(attention_geometries(
        build_model("cswin_simam_1024", device=dev, seed=SEED)))
    long_rows = long_window_phase(torch, F, dev, randn, geoms_long, geoms2048)
    table.update({f"flash {k}": row for k, row in long_rows.items()})

    # ---- 4c. the last six kernel bodies and their three entry points ----
    phase("remaining kernels vs plain versions (K-LN, K-LN', K5, K-V1) and their entry points")
    rest_rows, rest_summary = remaining_kernels_phase(torch, F, dev, randn, _build, build_model,
                                                      model, model448)

    # ---- 5. serving ----
    phase("serving CSWin-SimAM-UNet 512^2 bf16, kernels on")
    server = Server(model)
    rs = __import__("numpy").random.RandomState(SEED)
    requests = [rs.randint(0, 256, (b, IMG, IMG, 3), dtype="uint8") for b in (1, 3, 8, 11)]
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = [server(r) for r in requests]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    serve_bodies = {k: n for k, n in _build.BODY_LAUNCHES.items() if n}
    log(f"launches over requests of batch 1, 3, 8, 11: {launches}; bodies: {serve_bodies}")
    for req, out in zip(requests, outs):
        b = req.shape[0]
        require(tuple(out.shape) == (b, IMG, IMG, 1), f"output shape {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), "non-finite probabilities")
        require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
                "probabilities outside [0, 1]")
        log(f"  batch {b}: shape {tuple(out.shape)} {out.dtype} "
            f"range [{float(out.min()):.4f}, {float(out.max()):.4f}] "
            f"mean {float(out.float().mean()):.4f}")
    # 5 forwards: bucket 1, 4, 8, then 8 + 4
    per_forward = {stripe_attention.KERNEL: len([m for m in model.modules()
                                                 if isinstance(m, LePEAttention)]),
                   carafe_kernels.KERNEL: len(ups), carafe_head.MOMENTS_KERNEL: 1,
                   carafe_head.HEAD_KERNEL: 1}
    for name, n in per_forward.items():
        require(launches[name] == 5 * n,
                f"{name}: {launches[name]} launches, expected {5 * n}")
    # bf16 at head dim 32: K-A's tensor-core body, every launch
    ka_mma = f"{stripe_attention.KERNEL}:mma"
    require(serve_bodies == {ka_mma: 5 * per_forward[stripe_attention.KERNEL]},
            f"serving body launches {serve_bodies}")

    _build.reset_launches()
    server(requests[2])
    torch.cuda.synchronize()
    batch8 = {k: n for k, n in _build.LAUNCHES.items() if n}
    bodies8 = {k: n for k, n in _build.BODY_LAUNCHES.items() if n}
    log(f"launches of one batch-8 request: {batch8}; bodies: {bodies8}")
    require(batch8 == per_forward, f"batch-8 launches {batch8} != {per_forward}")
    require(bodies8 == {ka_mma: per_forward[stripe_attention.KERNEL]},
            f"batch-8 body launches {bodies8}")

    x2 = torch.from_numpy(requests[1][:2]).to(dev).float() / 255.0
    with torch.inference_mode():
        on = model.predict(x2, use_kernels=True).float()
        off = model.predict(x2, use_kernels=False).float()
    diff_bf16 = float((on - off).abs().max())
    log(f"kernels on vs off, bf16, batch 2: max |dp| {diff_bf16:.3e} "
        f"mean {float((on - off).abs().mean()):.3e} (tol {TOL_MODEL_BF16:g})")
    require(diff_bf16 <= TOL_MODEL_BF16, f"bf16 model diff {diff_bf16}")
    del on, off
    model32 = build_model("cswin_simam_512", device=dev, seed=SEED, dtype="float32")
    with torch.inference_mode():
        on = model32.predict(x2[:1], use_kernels=True)
        off = model32.predict(x2[:1], use_kernels=False)
    diff_f32 = float((on - off).abs().max())
    log(f"kernels on vs off, float32, batch 1: max |dp| {diff_f32:.3e} "
        f"(tol {TOL_MODEL_F32:g})")
    require(diff_f32 <= TOL_MODEL_F32, f"float32 model diff {diff_f32}")
    del on, off

    for _ in range(3):
        server(requests[2])
    torch.cuda.synchronize()
    n_req = 10
    t0 = time.perf_counter()
    for _ in range(n_req):
        server(requests[2])
    torch.cuda.synchronize()
    req_ms = (time.perf_counter() - t0) / n_req * 1e3
    log(f"batch-8 request: {req_ms:.2f} ms, {8e3 / req_ms:.1f} images/s "
        f"(mean of {n_req}, host clock, after 3 warm-up requests)")

    # 2048^2: the tiled K-A at stages 1-3 and the flash forward at stage 4
    phase("serving CSWin-SimAM-UNet 2048^2 bf16, kernels on")
    server2048 = Server(model2048)
    requests2048 = [rs.randint(0, 256, (b, IMG2048, IMG2048, 3), dtype="uint8") for b in (1, 2)]
    per_forward2048 = {stripe_attention.TILED_KERNEL: 48, flash_attention.FWD_KERNEL + ":flash": 2,
                       carafe_kernels.KERNEL: len(ups), carafe_head.MOMENTS_KERNEL: 1,
                       carafe_head.HEAD_KERNEL: 1}
    require(sum(geoms2048.values()) == 50, f"2048^2 attention branches {geoms2048}")
    # the tiled K-A and the flash path's forward: the tensor-core body, every launch
    bodies_fwd2048 = {f"{flash_attention.FWD_KERNEL}:{m}:mma": n
                      for m, n in (("window", 48), ("flash", 2))}
    for req in requests2048:
        torch.cuda.synchronize()
        _build.reset_launches()
        out = server2048(req)
        torch.cuda.synchronize()
        got = {k: n for k, n in _build.LAUNCHES.items() if n}
        got_bodies = {k: n for k, n in _build.BODY_LAUNCHES.items() if n}
        b = req.shape[0]
        log(f"  batch {b}: launches {got}; bodies {got_bodies}; shape {tuple(out.shape)} range "
            f"[{float(out.min()):.4f}, {float(out.max()):.4f}]")
        require(got == per_forward2048, f"2048^2 batch-{b} launches {got} != {per_forward2048}")
        require(got_bodies == bodies_fwd2048,
                f"2048^2 batch-{b} body launches {got_bodies} != {bodies_fwd2048}")
        require(tuple(out.shape) == (b, IMG2048, IMG2048, 1), f"output shape {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), "non-finite probabilities at 2048^2")
        require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
                "probabilities outside [0, 1] at 2048^2")
    serve2048 = dict(launches_per_forward=per_forward2048)
    x2 = torch.from_numpy(requests2048[1]).to(dev).float() / 255.0
    with torch.inference_mode():
        on = model2048.predict(x2, use_kernels=True).float()
        off = model2048.predict(x2, use_kernels=False).float()
    diff2048 = float((on - off).abs().max())
    log(f"kernels on vs off, 2048^2, bf16, batch 2: max |dp| {diff2048:.3e} "
        f"mean {float((on - off).abs().mean()):.3e} (tol {TOL_MODEL_BF16:g})")
    require(diff2048 <= TOL_MODEL_BF16, f"2048^2 bf16 model diff {diff2048}")
    del on, off, x2
    torch.cuda.empty_cache()
    for b, req in zip((1, 2), requests2048):
        server2048(req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            server2048(req)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        serve2048[f"batch{b}_ms"], serve2048[f"batch{b}_images_per_s"] = ms, b * 1e3 / ms
        log(f"2048^2 batch-{b} request: {ms:.2f} ms, {b * 1e3 / ms:.2f} images/s (mean of 3, "
            f"host clock, after 1 warm-up request)")
    serve2048["max_abs_dp_on_off_bf16"] = diff2048


    # ---- 6. training ----
    per_step = {**per_forward, stripe_attention.BWD_KERNEL: per_forward[stripe_attention.KERNEL],
                carafe_kernels.BWD_KERNEL: per_forward[carafe_kernels.KERNEL],
                carafe_head.BWD1_KERNEL: 1, carafe_head.FUSED_BWD_KERNEL: 1}
    n_attn448 = len([m for m in model448.modules() if isinstance(m, LePEAttention)])
    per_step448 = {stripe_attention.KERNEL: n_attn448, stripe_attention.BWD_KERNEL: n_attn448,
                   carafe_kernels.KERNEL: len(ups), carafe_kernels.BWD_KERNEL: len(ups),
                   carafe_head.MOMENTS_KERNEL: 1, carafe_head.HEAD_KERNEL: 1,
                   carafe_head.BWD1_NOGATE_KERNEL: 1, carafe_head.FUSED_BWD_NOGATE_KERNEL: 1}
    per_step2048 = {**per_forward2048, carafe_kernels.BWD_KERNEL: len(ups),
                    carafe_head.BWD1_KERNEL: 1, carafe_head.FUSED_BWD_KERNEL: 1,
                    **{n: 48 for n in stripe_attention.TILED_BWD_KERNELS},
                    flash_attention.DQ_KERNEL + ":flash": 2,
                    flash_attention.DKV_KERNEL + ":flash": 2}
    # every bf16 path runs the tensor-core bodies (K-A and K-A'; the 2048^2
    # step's forward, dq and dk/dv), cswinunet (float32) the CUDA-core K-A
    # and K-A' only
    bodies2048 = {f"{e}:{m}:mma": n for e in _build.FLASH_ENTRIES
                  for m, n in (("window", 48), ("flash", 2))}
    bodies512 = {f"{e}:mma": per_step[stripe_attention.KERNEL]
                 for e in (stripe_attention.KERNEL, stripe_attention.BWD_KERNEL)}
    bodies448 = {f"{e}:fma": n_attn448 for e in (stripe_attention.KERNEL,
                                                  stripe_attention.BWD_KERNEL)}
    model0 = build_model("cswin_simam_512", device=dev, seed=SEED, **NO_DROPS)
    runs = {}
    for label, net, cfg_name, want_step, want_bodies in (
            ("cswin_simam_512 drops 0.3", model, "cswin_simam_512", per_step, bodies512),
            ("cswin_simam_512 drops 0", model0, "cswin_simam_512", per_step, bodies512),
            ("cswinunet drops 0.3", model448, "cswinunet", per_step448, bodies448),
            ("cswin_simam_2048 drops 0.3", model2048, "cswin_simam_2048", per_step2048,
             bodies2048)):
        runs[label] = train_phase(torch, engine, _build, label, net, TRAIN_CONFIGS[cfg_name],
                                  want_step, dev, want_bodies)
    del model0
    train_launches = runs["cswin_simam_512 drops 0.3"]["launches"]
    train_launches448 = runs["cswinunet drops 0.3"]["launches"]
    train_launches2048 = runs["cswin_simam_2048 drops 0.3"]["launches"]
    bodies2048_run = runs["cswin_simam_2048 drops 0.3"]["bodies"]
    bodies512_run = runs["cswin_simam_512 drops 0.3"]["bodies"]
    del model2048, server2048
    torch.cuda.empty_cache()

    # kernels on against kernels off, one batch-2 step from the same weights
    # and the same dropout seed (so the same masks)
    def grads_of(net, use_kernels, images_d, masks_d):
        net.zero_grad(set_to_none=True)
        loss, _, _ = engine.compute_gradients(net, images_d, masks_d, net.num_classes,
                                              use_kernels, rng=DROP_SEED)
        grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        return float(loss), grads

    def compare_f32(label, net, img, batch=CHECK_BATCH):
        images_d, masks_d = disc_batch(torch, img, batch, dev, net.num_classes)
        loss_on, g_on = grads_of(net, True, images_d, masks_d)
        loss_off, g_off = grads_of(net, False, images_d, masks_d)
        worst_name, worst = "", 0.0
        for name, g in g_off.items():
            rel = float((g_on[name] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            if rel > worst:
                worst_name, worst = name, rel
            require(rel <= TOL_GRAD_F32, f"{label}: float32 gradient of {name}: rel gap {rel}")
        log(f"gradients, kernels on vs off, {label}, float32, batch {batch}, dropout "
            f"seed {DROP_SEED}: loss {loss_on:.6f} vs {loss_off:.6f}; largest gap "
            f"{worst:.3e} x max|g| ({worst_name}) over {len(g_off)} parameters "
            f"(tol {TOL_GRAD_F32:g})")
        return worst

    phase("gradients, kernels on vs off, drops 0.3, one dropout seed")
    grad_gap = compare_f32("cswin_simam_512 drops 0.3", model32, IMG)
    del model32
    grad_gap448 = compare_f32("cswinunet drops 0.3", model448, IMG448)
    # 2048^2 at full width, depth (1,1,1,1) so that the kernels-off path's N^2
    # scores fit; attention dropout 0 there: the flash path's mask (tiles of
    # 512 in band order, as JAX's flash kernel) is not the plain path's
    # whole-window mask, so the two would drop different stage-4 scores
    model2048_d1 = build_model("cswin_simam_2048", device=dev, seed=SEED, dtype="float32",
                               depth=(1, 1, 1, 1), attn_drop_rate=0.0)
    grad_gap2048 = compare_f32("cswin_simam_2048 depth (1,1,1,1), drops 0.3 but attention "
                               "drop 0", model2048_d1, IMG2048, batch=1)
    del model2048_d1
    torch.cuda.empty_cache()
    images_d, masks_d = disc_batch(torch, IMG, CHECK_BATCH, dev)
    loss_on, g_on = grads_of(model, True, images_d, masks_d)
    loss_off, g_off = grads_of(model, False, images_d, masks_d)
    groups: dict = {}
    for name, g in g_off.items():
        rel = float((g_on[name] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        grp = name.split(".")[0]
        groups[grp] = max(groups.get(grp, 0.0), rel)
    log(f"gradients, kernels on vs off, bf16, drops 0.3, batch {CHECK_BATCH}: loss "
        f"{loss_on:.6f} vs {loss_off:.6f} (tol {TOL_LOSS_BF16:g}); largest rel gap per group: "
        + ", ".join(f"{k} {v:.2e}" for k, v in groups.items()))
    require(abs(loss_on - loss_off) <= TOL_LOSS_BF16, "bf16 loss, kernels on vs off")
    del g_on, g_off

    # the multi-class step: cswin_simam_512_dp, 4 classes, its global batch
    # of 16 on one card; the head's F = 4 kernels in a real step
    model_dp = build_model("cswin_simam_512_dp", device=dev, seed=SEED)
    runs["cswin_simam_512_dp drops 0.3"] = train_phase(
        torch, engine, _build, "cswin_simam_512_dp drops 0.3", model_dp,
        TRAIN_CONFIGS["cswin_simam_512_dp"], per_step, dev, bodies512)
    phase("gradients, kernels on vs off, cswin_simam_512_dp (4 classes), drops 0.3")
    model_dp32 = build_model("cswin_simam_512_dp", device=dev, seed=SEED, dtype="float32")
    grad_gap_dp = compare_f32("cswin_simam_512_dp drops 0.3", model_dp32, IMG)
    del model_dp32
    images_d, masks_d = disc_batch(torch, IMG, CHECK_BATCH, dev, model_dp.num_classes)
    loss_on_dp, _ = grads_of(model_dp, True, images_d, masks_d)
    loss_off_dp, _ = grads_of(model_dp, False, images_d, masks_d)
    log(f"cswin_simam_512_dp, bf16, drops 0.3, batch {CHECK_BATCH}: loss {loss_on_dp:.6f} "
        f"kernels on vs {loss_off_dp:.6f} off (tol {TOL_LOSS_BF16:g})")
    require(abs(loss_on_dp - loss_off_dp) <= TOL_LOSS_BF16,
            "cswin_simam_512_dp bf16 loss, kernels on vs off")
    del model_dp
    torch.cuda.empty_cache()

    fit_run = fit_phase(torch, engine, _build, model, TRAIN_CONFIGS["cswin_simam_512"],
                        per_step, bodies512, per_forward,
                        {ka_mma: per_forward[stripe_attention.KERNEL]})
    accum_run = grad_accum_phase(torch, engine, _build, build_model, NO_DROPS, per_step, dev)

    # ---- 7. data, checkpoints and the CLI ----
    phase("data, checkpoints and the CLI: JPEG decoders")
    decoders = decoder_probe()
    data_run = {"decoders": decoders, "augment": augment_phase(torch, dev)}
    from cswin_simam_unet_tpu_torch.data import AugmentConfig
    for label, aug in (("cswin_simam_512 drops 0.3, not augmented", None),
                       ("cswin_simam_512 drops 0.3, augmented", AugmentConfig())):
        data_run[label] = train_phase(torch, engine, _build, label, model,
                                      TRAIN_CONFIGS["cswin_simam_512"], per_step, dev,
                                      bodies512, augment=aug)
    data_run["files"] = files_phase(torch, engine, _build, build_model, model,
                                    TRAIN_CONFIGS["cswin_simam_512"], per_step, per_forward,
                                    decoders)
    data_run["cli"] = cli_phase(decoders)

    # ---- 8. the UNet family ----
    unet_run = {"card_vs_cpu": unet_cpu_phase(torch, engine, _build, build_model, dev)}
    unet_run.update(unet_timing_phase(torch, engine, _build, build_model, TRAIN_CONFIGS, dev,
                                      default_tf32))
    unet_run["fit"] = unet_fit_phase(torch, engine, _build, build_model, TRAIN_CONFIGS,
                                     decoders, dev)
    unet_run["cli"] = unet_cli_phase(torch, build_model, decoders, dev)

    # ---- 9. results ----
    sources = {
        "K-A": ("csu_stripe_attention_fwd", "cswin_simam_unet_tpu_torch/csrc/stripe_attention.cu",
                "cswin_simam_unet_tpu/ops/pallas_attention_v2.py:180"),
        "K-C": ("csu_carafe_fwd", "cswin_simam_unet_tpu_torch/csrc/carafe_head_fwd.cu",
                "cswin_simam_unet_tpu/ops/pallas_carafe.py:176"),
        "K-H1": ("csu_carafe_head_fwd", "cswin_simam_unet_tpu_torch/csrc/carafe_head_fwd.cu",
                 "cswin_simam_unet_tpu/ops/pallas_carafe_head.py:76"),
        "K-H2": ("csu_simam_head_fwd", "cswin_simam_unet_tpu_torch/csrc/simam_head.cu",
                 "cswin_simam_unet_tpu/ops/pallas_simam_head.py:109"),
        "K-A'": ("csu_stripe_attention_bwd",
                 "cswin_simam_unet_tpu_torch/csrc/stripe_attention_bwd.cu",
                 "cswin_simam_unet_tpu/ops/pallas_attention_v2.py:219"),
        "K-C'": ("csu_carafe_bwd", "cswin_simam_unet_tpu_torch/csrc/carafe_head_bwd.cu",
                 "cswin_simam_unet_tpu/ops/pallas_carafe.py:196"),
        "K3": ("csu_head_bwd1", "cswin_simam_unet_tpu_torch/csrc/simam_head.cu",
               "cswin_simam_unet_tpu/ops/pallas_simam_head.py:124"),
        "K4": ("csu_carafe_head_bwd", "cswin_simam_unet_tpu_torch/csrc/carafe_head_bwd.cu",
               "cswin_simam_unet_tpu/ops/pallas_carafe_head.py:163"),
        "K3 no gate": ("csu_head_bwd1_nogate", "cswin_simam_unet_tpu_torch/csrc/simam_head.cu",
                       "cswin_simam_unet_tpu/ops/pallas_simam_head.py:178"),
        "K4 no gate": ("csu_carafe_head_bwd_nogate",
                       "cswin_simam_unet_tpu_torch/csrc/carafe_head_bwd.cu",
                       "cswin_simam_unet_tpu/ops/pallas_carafe_head.py:163"),
        "flash fwd": (flash_attention.FWD_KERNEL,
                      "cswin_simam_unet_tpu_torch/csrc/flash_attention_fwd.cu",
                      "cswin_simam_unet_tpu/ops/pallas_attention_flash.py:148"),
        "flash dq": (flash_attention.DQ_KERNEL,
                     "cswin_simam_unet_tpu_torch/csrc/flash_attention_dq.cu",
                     "cswin_simam_unet_tpu/ops/pallas_attention_flash.py:186"),
        "flash dkv": (flash_attention.DKV_KERNEL,
                      "cswin_simam_unet_tpu_torch/csrc/flash_attention_dkv.cu",
                      "cswin_simam_unet_tpu/ops/pallas_attention_flash.py:220"),
    }
    # the window mode of the flash family is the tiled K-A / K-A'
    window_replaces = {"flash fwd": "cswin_simam_unet_tpu/ops/pallas_attention_v2.py:180",
                       "flash dq": "cswin_simam_unet_tpu/ops/pallas_attention_v2.py:219",
                       "flash dkv": "cswin_simam_unet_tpu/ops/pallas_attention_v2.py:219"}
    kernels = []
    for label, (fn, src, replaces) in sources.items():
        row = table[label]
        # launches: one training step of the path that runs the kernel
        # (cswin_simam_512 at drops 0.3, cswinunet for the two without gate,
        # cswin_simam_2048 for the flash family, both modes)
        if label in window_replaces:
            modes = {m: train_launches2048.get(f"{fn}:{m}", 0) for m in _build.FLASH_MODES}
            n_step = sum(modes.values())
        else:
            path = train_launches if train_launches.get(fn) else train_launches448
            n_step = path[fn]
        entry = {
            "name": f"{label} {fn}", "route": "cuda", "source": src, "replaces": replaces,
            "launches": n_step, "launches_cswinunet_step": train_launches448.get(fn, 0),
            "launches_serving": launches.get(fn, 0),
            "launches_per_forward": batch8.get(fn, 0),
            "max_abs_err": row.get("abs32", row["err32"]),
            "max_abs_err_bf16": row["err16"],
            "err_scaled_by_max_plain": "abs32" in row,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "pass": True,
        }
        if "ms_drop" in row:
            entry.update(ms_dropout=row["ms_drop"], plain_ms_dropout=row["plain_ms_drop"],
                         library_ms_dropout=row["library_ms_drop"],
                         max_abs_err_dropout=row.get("abs32_drop", row["err32_drop"]),
                         max_abs_err_bf16_dropout=row["err16_drop"])
        if "rel16" in row:
            entry.update(err_over_max_plain=row["rel32"], err_over_max_plain_bf16=row["rel16"],
                         err_over_max_plain_dropout=row["rel32_drop"],
                         err_over_max_plain_bf16_dropout=row["rel16_drop"])
        if label in window_replaces:
            entry.update(
                path="cswin_simam_2048 training step, batch 1, bf16",
                err_scaled_by_max_plain=label != "flash fwd",
                launches_window=modes["window"], launches_flash=modes["flash"],
                replaces_window_mode=window_replaces[label],
                launches_per_forward=per_forward2048.get(f"{fn}:flash", 0) + (
                    48 if label == "flash fwd" else 0),
                ms_window=row["ms_window"], ms_flash=row["ms_flash"],
                bound_ms_window=row["bound_ms_window"], bound_ms_flash=row["bound_ms_flash"])
        if label in ("K-A", "K-A'", "flash fwd", "flash dq", "flash dkv"):  # the tensor-core body
            if label in ("K-A", "K-A'"):
                launches_mma = bodies512_run.get(f"{fn}:mma", 0)
            else:
                launches_mma = {m: bodies2048_run.get(f"{fn}:{m}:mma", 0)
                                for m in _build.FLASH_MODES}
            entry.update(
                body="mma.sync m16n8k16 bf16 (csrc/" + (
                    "attention_fwd_mma.cuh)" if label in ("K-A", "flash fwd")
                    else "flash_attention_mma.cuh)"),
                launches_mma=launches_mma,
                **{k: row[k] for k in ("device_ms", "device_ms_drop", "ms_fma_f32",
                                       "ms_fma_f32_drop")})
        if label in ("K3", "K4", "K3 no gate", "K4 no gate", "K-H1", "K-H2", "K-C", "K-C'"):
            entry.update({k: row[k] for k in ("device_ms", "device_ms_2048", "device_ms_448")
                          if k in row})
        if "own16" in row:
            entry.update(err_over_max_plain=row["own32"], err_over_max_plain_bf16=row["own16"])
        if label == "flash fwd":
            entry.update({k: row[k] for k in ("device_ms_window", "device_ms_flash",
                                              "bands_window_ms", "bands_flash_ms")})
        if label == "K-A'":
            entry.update(path="cswin_simam_512 training step, batch 8, bf16",
                         launches_fma_cswinunet_step=runs["cswinunet drops 0.3"]["bodies"].get(
                             f"{fn}:fma", 0),
                         **{k: row[k] for k in ("library_device_ms", "library_device_ms_drop",
                                                "device_ms_dq", "device_ms_dkv",
                                                "device_ms_dkv_no_lepe")})
        kernels.append(entry)
    rest_sources = {
        "K-LN": ("csu_layernorm_fwd", "cswin_simam_unet_tpu_torch/csrc/layernorm.cu",
                 "cswin_simam_unet_tpu/ops/pallas_layernorm.py:51"),
        "K-LN'": ("csu_layernorm_bwd", "cswin_simam_unet_tpu_torch/csrc/layernorm.cu",
                  "cswin_simam_unet_tpu/ops/pallas_layernorm.py:60"),
        "K5": ("csu_head_bwd2", "cswin_simam_unet_tpu_torch/csrc/simam_head.cu",
               "cswin_simam_unet_tpu/ops/pallas_simam_head.py:145"),
        "K5 no gate": ("csu_head_bwd2_nogate", "cswin_simam_unet_tpu_torch/csrc/simam_head.cu",
                       "cswin_simam_unet_tpu/ops/pallas_simam_head.py:169"),
        "K-V1": ("csu_window_attention_fwd",
                 "cswin_simam_unet_tpu_torch/csrc/window_attention.cu",
                 "cswin_simam_unet_tpu/ops/pallas_attention.py:52"),
        "K-V1'": ("csu_window_attention_bwd",
                  "cswin_simam_unet_tpu_torch/csrc/window_attention.cu",
                  "cswin_simam_unet_tpu/ops/pallas_attention.py:74"),
    }
    rest_paths = {
        "K-LN": "FusedLayerNorm(use_kernel=True) forward at the 4 LayerNorm shapes of "
                "cswin_simam_512 (batch 8, bf16; ms summed over the 4) and of cswinunet",
        "K5": "CARAFE(flat_raw) -> FusedSimAMHead backward, flat map (8, 128, 128, 1024) bf16",
        "K-V1": "stripe_attention_v1 at the window geometries of cswin_simam_512 (batch 8, "
                "bf16; ms summed over its 50 attention branches) and of cswinunet",
    }
    for label, (fn, src, replaces) in rest_sources.items():
        row = rest_rows[label]
        entry = {
            "name": f"{label} {fn}", "route": "cuda", "source": src, "replaces": replaces,
            "launches": row["launches"], "max_abs_err": row.get("abs32", row["err32"]),
            "max_abs_err_bf16": row["err16"], "err_scaled_by_max_plain": "abs32" in row,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "library_device_ms": row["library_device_ms"],
            "path": rest_paths[label.split("'")[0].replace(" no gate", "")],
            "per_shape": row["shapes"], "pass": True,
        }
        entry.update({k: v for k, v in row.items() if k.endswith("_flagship_step")
                      or k == "layernorms_per_flagship_step"})
        if label == "K-LN'":
            entry.update({k: row[k] for k in ("device_ms_448", "bound_ms_448",
                                              "library_device_ms_448", "per_shape_448",
                                              "launches_vec")},
                         body="vec: 16-byte loads (csrc/layernorm.cu), scalar off the width",
                         err_over_max_plain=row["own32"], err_over_max_plain_bf16=row["own16"])
        if label in ("K5", "K5 no gate"):
            entry.update({k: row[k] for k in ("device_ms_2048", "bound_ms_2048",
                                              "device_ms_448", "bound_ms_448", "floors")},
                         err_over_max_plain_bf16=row["own16"])
        if label in ("K-V1", "K-V1'"):  # bf16 at head dims 16-64 on the tensor cores
            entry.update(body="mma.sync m16n8k16 bf16 (csrc/" + (
                "attention_fwd_mma.cuh)" if label == "K-V1" else "window_attention.cu)"),
                launches_mma=row["launches_mma"], launches_fma_cswinunet=row["launches_fma"],
                bwd_design_flagship=row["design"])
            if "own16" in row:
                entry["err_over_max_plain_bf16"] = row["own16"]
        kernels.append(entry)
    log("remaining kernels: " + json.dumps(rest_summary))
    log("training: " + json.dumps({k: {m: v for m, v in r.items()
                                       if m not in ("launches", "bodies")}
                                   for k, r in runs.items()}))
    log("serving 2048^2: " + json.dumps(serve2048))
    log("fit: " + json.dumps(fit_run))
    log("gradient accumulation: " + json.dumps(accum_run))
    log("data: " + json.dumps({k: ({m: v for m, v in r.items() if m not in ("launches", "bodies")}
                                   if isinstance(r, dict) else r)
                               for k, r in data_run.items()}))
    log("unet: " + json.dumps(unet_run))
    log(f"f32 gradient gaps, kernels on vs off at drops 0.3: cswin_simam_512 {grad_gap:.3e}, "
        f"cswinunet {grad_gap448:.3e}; cswin_simam_2048 at depth (1,1,1,1), attention drop "
        f"0: {grad_gap2048:.3e}; cswin_simam_512_dp {grad_gap_dp:.3e}; K-A keep rate "
        f"{table['K-A']['keep_rate']:.6f}")
    log(f"build {build_s:.1f} s, whole run {time.perf_counter() - T_START:.1f} s")
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
