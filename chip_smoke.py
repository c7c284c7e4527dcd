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
   window geometry of ``cswin_simam_512`` and of ``cswinunet``, and timed at
   rate 0.3 beside rate 0 (library: SDPA with ``dropout_p``);
4. each backward kernel (K-A', K-C', K3, K4, and K3 and K4 without the gate)
   the same way, at the training step's shapes, every output of the kernel
   checked; K-A' with dropout as K-A; the two kernels without the gate at
   ``cswinunet``'s head (448^2, float32, batch 2);
5. serving: CSWin-SimAM-UNet at 512^2, full width, bf16, kernels on, random
   weights from a seed, served through ``Server`` for requests of batch 1,
   3, 8 and 11 (launch counts reset before and read after); output checks;
   kernels-on against kernels-off in bf16 (batch 2) and float32 (batch 1);
   the launch counts of one batch-8 request; ms per batch-8 request and
   images/s;
6. training, each path driven by ``make_train_step`` (AdamW, lr 1e-4, weight
   decay 1e-4) on one fixed uint8 batch of bright discs: the launch counts
   of one step (counts reset before and read after), 3 warm-up and 10 timed
   steps (ms per step, images/s, peak device memory), a finite loss whose
   mean over the last 3 of 13 steps is below the first, Dice and IoU in
   [0, 1].  The paths: ``cswin_simam_512`` (bf16, batch 8) at drops 0.3, the
   configs' headline; the same at drops 0; ``cswinunet`` (448^2, no SimAM,
   float32, batch 2) at drops 0.3.  Then one batch-2 step's gradients with
   kernels on against kernels off from the same weights and the same dropout
   seed, every parameter, in float32 for both configs (the masks are the
   same, so the gradients must agree) and the loss in bf16.

The last two lines are the kernel table as JSON and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
port next to this file, it exits non-zero and prints no result.  Each phase
header carries the seconds since the start; a run still going after
``DEADLINE_S`` prints every thread's traceback and exits non-zero, so a hang
names its line instead of running into an outside time limit.
"""

from __future__ import annotations

import copy
import faulthandler
import json
import math
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

IMG = 512
IMG448 = 448                        # cswinunet
SEED = 0
DROP = 0.3                          # the configs' drop / attention-drop / drop-path
DROP_SEED = 2 ** 31 + 12345         # attention-dropout seed of the kernel checks
TIME_BATCH = 8                      # kernels timed at the served bucket
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,   # dense bf16 tensor cores
              "float32": 67e12}     # float32 outside the tensor cores
TOL_F32 = 1e-4                      # max |kernel - plain|, float32 inputs
TOL_BF16 = 2e-2                     # x max(1, max|plain|), bf16 inputs
# backward kernels, float32: x max(1, max|plain|) of each output, since their
# reductions over the batch (dw, A, B, dW, db) reach O(100)
TOL_BWD_F32 = 1e-4
TOL_STATS = 1e-4                    # x (1 + |plain|), K-H1 pooled moments
TOL_MODEL_BF16 = 5e-2               # probabilities, kernels on vs off, bf16
TOL_MODEL_F32 = 1e-3                # probabilities, kernels on vs off, f32
TOL_GRAD_F32 = 1e-3                 # x max|g| per parameter, kernels on vs off, f32
TOL_LOSS_BF16 = 1e-2                # training loss, kernels on vs off, bf16
TRAIN_WARMUP, TRAIN_STEPS, CHECK_BATCH = 3, 10, 2
DEADLINE_S = 1100                   # the whole run takes about 70 s on the H100
LOSS_TAIL = 3                       # the mean of the last 3 losses is below the first


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


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def check_pair(name, torch, kernel_fn, plain_fn, make, batch=2):
    """Kernel vs plain at float32 and at bf16; returns the float32 error."""
    x32 = make(batch, torch.float32)
    err32 = max_err(kernel_fn(*x32), plain_fn(*x32))
    x16 = make(batch, torch.bfloat16)
    ref16 = plain_fn(*[t.float() if t.is_floating_point() else t for t in x16])
    err16 = max_err(kernel_fn(*x16), ref16)
    tol16 = TOL_BF16 * max(1.0, float(ref16.abs().max()))
    torch.cuda.synchronize()
    log(f"  {name}: f32 max_abs_err {err32:.3e} (tol {TOL_F32:g})  "
        f"bf16 max_abs_err {err16:.3e} (tol {tol16:.3e})")
    require(err32 <= TOL_F32, f"{name}: float32 error {err32} > {TOL_F32}")
    require(err16 <= tol16, f"{name}: bf16 error {err16} > {tol16}")
    return err32, err16


def check_outputs(name, torch, kernel_fn, plain_fn, make, batch=2):
    """Backward kernel vs plain at float32 and at bf16, every output; the
    error of each output is taken relative to max(1, max|plain|) of it.
    Returns the largest scaled errors (float32, bf16) and the largest
    absolute one in float32."""
    errs, abs32 = [], 0.0
    for dtype, tol in ((torch.float32, TOL_BWD_F32), (torch.bfloat16, TOL_BF16)):
        args = make(batch, dtype)
        got = kernel_fn(*args)
        want = plain_fn(*[t.float() if t.is_floating_point() else t for t in args])
        worst = 0.0
        for g, w in zip(got, want):
            require(tuple(g.shape) == tuple(w.shape), f"{name}: shape {tuple(g.shape)} "
                    f"!= {tuple(w.shape)}")
            err = max_err(g, w)
            if dtype == torch.float32:
                abs32 = max(abs32, err)
            worst = max(worst, err / max(1.0, float(w.abs().max())))
        torch.cuda.synchronize()
        require(worst <= tol, f"{name}: {dtype} scaled error {worst} > {tol}")
        errs.append(worst)
    log(f"  {name}: f32 scaled err {errs[0]:.3e} (tol {TOL_BWD_F32:g})  "
        f"bf16 scaled err {errs[1]:.3e} (tol {TOL_BF16:g})  f32 max abs err {abs32:.3e}")
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


def disc_batch(torch, img: int, batch: int, dev):
    """A fixed uint8 batch of bright discs on noise and their masks, on dev."""
    import numpy as np
    rs = np.random.RandomState(SEED + 1)
    yy, xx = np.mgrid[:img, :img]
    images = rs.randint(0, 160, (batch, img, img, 3)).astype("uint8")
    masks = np.zeros((batch, img, img, 1), "uint8")
    for i in range(batch):  # a learnable batch
        for _ in range(3):
            cy, cx = rs.randint(img // 8, img - img // 8, size=2)
            rad = rs.randint(20, 60)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < rad * rad
            images[i][disc] = 255
            masks[i, disc, 0] = 255
    return torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev)


def train_phase(torch, engine, _build, label, model, tcfg, want_step, dev) -> dict:
    """Train a copy of ``model`` with ``make_train_step`` on one fixed batch:
    the launch counts of one step (reset before, read after) must be
    ``want_step``; then 3 warm-up and 10 timed steps.  Returns the step's ms,
    images/s, peak memory, launches and the losses."""
    img = model.img_size
    phase(f"training {label}, {img}^2, {model.dtype}, kernels on: {tcfg}")
    images_d, masks_d = disc_batch(torch, img, tcfg.batch_size, dev)
    trained = copy.deepcopy(model)
    opt = engine.make_optimizer(tcfg.optimizer, tcfg.learning_rate, tcfg.weight_decay,
                                trained.parameters())
    step = engine.make_train_step(trained, opt, seed=SEED)
    torch.cuda.synchronize()
    _build.reset_launches()
    history = [step(images_d, masks_d)]
    torch.cuda.synchronize()
    one_step = {k: n for k, n in _build.LAUNCHES.items() if n}
    log(f"launches of one training step: {one_step}")
    require(one_step == want_step, f"{label}: step launches {one_step} != {want_step}")
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
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    require(timed == {k: TRAIN_STEPS * n for k, n in want_step.items()},
            f"{label}: timed-loop launches {timed}")
    hist = [{k: float(v) for k, v in h.items()} for h in history]
    for i, h in enumerate(hist):
        log(f"  step {i}: loss {h['loss']:.6f} dice {h['dice']:.4f} iou {h['iou']:.4f}")
        require(math.isfinite(h["loss"]), f"{label} step {i}: non-finite loss")
        require(0.0 <= h["dice"] <= 1.0 and 0.0 <= h["iou"] <= 1.0,
                f"{label} step {i}: dice/iou outside [0, 1]")
    tail = sum(h["loss"] for h in hist[-LOSS_TAIL:]) / LOSS_TAIL
    require(tail < hist[0]["loss"], f"{label}: the loss did not fall on a fixed batch")
    ips = tcfg.batch_size * 1e3 / step_ms
    log(f"training step {label}, batch {tcfg.batch_size}: {step_ms:.2f} ms, {ips:.1f} "
        f"images/s (mean of {TRAIN_STEPS}, host clock after synchronize, {TRAIN_WARMUP} "
        f"warm-up steps); peak device memory {peak_gib:.2f} GiB; loss {hist[0]['loss']:.4f} "
        f"-> mean of last {LOSS_TAIL} {tail:.4f}")
    del trained, opt, step
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, images_per_s=ips, peak_gib=peak_gib, launches=one_step,
                first_loss=hist[0]["loss"], last3_mean_loss=tail,
                batch=tcfg.batch_size, img=img)


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
    from cswin_simam_unet_tpu_torch.ops import carafe_kernels, stripe_attention
    from cswin_simam_unet_tpu_torch.ops.simam import pooled_stats
    from cswin_simam_unet_tpu_torch.serving import Server
    from cswin_simam_unet_tpu_torch.train import engine

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
              library_ms_drop=0.0, err32_drop=0.0, err16_drop=0.0)
    for (reso, Cb, heads, hsp, wsp), count in sorted(geoms.items()):
        L = reso * reso
        kw = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads)
        kwd = dict(kw, attn_drop=DROP, seed=DROP_SEED)

        def make(B, dtype, L=L, Cb=Cb):
            qkv = randn(B, L, 6 * Cb, scale=0.5, dtype=dtype)  # branch slices
            return (qkv[..., :Cb], qkv[..., 2 * Cb:3 * Cb], qkv[..., 4 * Cb:5 * Cb],
                    randn(3, 3, 1, Cb, scale=1 / 3, dtype=dtype))

        name = f"K-A reso {reso} window {hsp}x{wsp} Cb {Cb} heads {heads}"
        e32, e16 = check_pair(name, torch,
                              lambda q, k, v, w, kw=kw: stripe_attention.stripe_attention(
                                  q, k, v, w, **kw),
                              lambda q, k, v, w, kw=kw: attention.stripe_attention(
                                  q, k, v, w, **kw), make)
        d32, d16 = check_pair(name + " dropout 0.3", torch,
                              lambda q, k, v, w, kw=kwd: stripe_attention.stripe_attention(
                                  q, k, v, w, **kw),
                              lambda q, k, v, w, kw=kwd: attention.stripe_attention(
                                  q, k, v, w, **kw), make)
        q, k, v, w = make(TIME_BATCH, torch.bfloat16)
        ms = time_ms(torch, lambda: stripe_attention.stripe_attention(q, k, v, w, **kw))
        ms_drop = time_ms(torch, lambda: stripe_attention.stripe_attention(q, k, v, w, **kwd))
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
        log(f"    x{count}/forward: kernel {ms:.4f} ms (dropout 0.3: {ms_drop:.4f})  plain "
            f"{plain:.4f} ms ({plain_drop:.4f})  sdpa {lib:.4f} ms ({lib_drop:.4f})  "
            f"bound {b_ms:.4f} ms")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bytes", nbytes), ("flops", flops), ("ms_drop", ms_drop),
                         ("plain_ms_drop", plain_drop), ("library_ms_drop", lib_drop)):
            ka[key] += count * val
        for key, val in (("err32", e32), ("err16", e16), ("err32_drop", d32),
                         ("err16_drop", d16)):
            ka[key] = max(ka[key], val)
    ka["bound_ms"], ka["bound_by"] = bound_ms(ka["bytes"], ka["flops"], "bfloat16")
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

        d32, d16 = check_pair(
            f"K-A 448^2 reso {reso} window {hsp}x{wsp} Cb {Cb} heads {heads} dropout 0.3",
            torch, lambda q, k, v, w, kw=kwd: stripe_attention.stripe_attention(q, k, v, w, **kw),
            lambda q, k, v, w, kw=kwd: attention.stripe_attention(q, k, v, w, **kw), make)
        ka["err32_drop"] = max(ka["err32_drop"], d32)
        ka["err16_drop"] = max(ka["err16_drop"], d16)
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

    # K-C at the three decoder CARAFEs
    kc = dict(ms=0.0, plain_ms=0.0, err32=0.0, err16=0.0, bytes=0.0, flops=0.0)
    ups = [m for n, m in model.named_modules()
           if isinstance(m, CARAFE) and n != "upsample1"]
    for i, mod in enumerate(ups):
        C = mod.out.weight.shape[0]
        reso = IMG // 4 // 2 ** (len(ups) - i)
        S = mod.up_factor

        def make(B, dtype, reso=reso, C=C, S=S):
            return randn(B, reso, reso, C, dtype=dtype), randn(B, reso, reso, 9 * S * S,
                                                                dtype=dtype)

        e32, e16 = check_pair(f"K-C x ({reso},{reso},{C}) S {S}", torch,
                              lambda x, e, S=S: carafe_kernels.carafe_flat(x, e, S),
                              lambda x, e, S=S: carafe.carafe_flat(x, e, S), make)
        x, e = make(TIME_BATCH, torch.bfloat16)
        ms = time_ms(torch, lambda: carafe_kernels.carafe_flat(x, e, S))
        plain = time_ms(torch, lambda: carafe.carafe_flat(x, e, S), iters=3)
        nbytes = (x.numel() + e.numel() + x.numel() * S * S) * 2
        flops = 2 * 9 * x.numel() * S * S
        b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
        log(f"    x1/forward: kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms:.4f} ms")
        kc["ms"] += ms
        kc["plain_ms"] += plain
        kc["bytes"] += nbytes
        kc["flops"] += flops
        kc["err32"] = max(kc["err32"], e32)
        kc["err16"] = max(kc["err16"], e16)
    kc["bound_ms"], kc["bound_by"] = bound_ms(kc["bytes"], kc["flops"], "bfloat16")
    kc["library_ms"] = None
    table["K-C"] = kc

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

    e32, e16 = check_pair("K-H1 x (128,128,64) S 4", torch, h1_kernel, h1_plain, make_h1)
    # the moments: pooled kernel sums against torch sums of the kernel's own map
    for dtype in (torch.float32, torch.bfloat16):
        x, e, b = make_h1(2, dtype)
        fb, s1, s2 = carafe_head.carafe_biased_moments(x, e, b, S)
        mu, v = pooled_stats(s1.reshape(2, -1, G * E).sum(1), s2.reshape(2, -1, G * E).sum(1),
                             r0 * r0 * G, G)
        fbf = fb.float()
        mu_p, v_p = pooled_stats(fbf.sum((1, 2)), (fbf * fbf).sum((1, 2)), r0 * r0 * G, G)
        rel = max(float(((mu - mu_p).abs() / (1 + mu_p.abs())).max()),
                  float(((v - v_p).abs() / (1 + v_p.abs())).max()))
        log(f"  K-H1 moments {dtype}: max rel err {rel:.3e} (tol {TOL_STATS:g})")
        require(rel <= TOL_STATS, f"K-H1 moments error {rel} > {TOL_STATS}")
    x, e, b = make_h1(TIME_BATCH, torch.bfloat16)
    ms = time_ms(torch, lambda: carafe_head.carafe_biased_moments(x, e, b, S))
    plain = time_ms(torch, lambda: h1_plain(x, e, b), iters=3)
    nbytes = (x.numel() + e.numel() + x.numel() * G + E) * 2 + 2 * TIME_BATCH * G * E * 4
    flops = 2 * 9 * x.numel() * G + 3 * x.numel() * G
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log(f"    x1/forward: kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms:.4f} ms")
    table["K-H1"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, err32=e32, err16=e16)

    def make_h2(B, dtype):
        fb = randn(B, r0, r0, G * E, dtype=dtype)
        return fb, randn(E, F_cls, scale=E ** -0.5, dtype=dtype)

    def h2_kernel(fb, w):
        fbf = fb.float()
        mu, v = pooled_stats(fbf.sum((1, 2)), (fbf * fbf).sum((1, 2)), r0 * r0 * G, G)
        return carafe_head.simam_head_flat(fb, mu, v, w, G)

    def h2_plain(fb, w):
        return carafe_head.head_reference(fb, torch.zeros(E, device=dev), w, G)

    e32, e16 = check_pair("K-H2 fb (128,128,1024) G 16", torch, h2_kernel, h2_plain, make_h2)
    fb, w = make_h2(TIME_BATCH, torch.bfloat16)
    fbf = fb.float()
    mu, v = pooled_stats(fbf.sum((1, 2)), (fbf * fbf).sum((1, 2)), r0 * r0 * G, G)
    del fbf
    ms = time_ms(torch, lambda: carafe_head.simam_head_flat(fb, mu, v, w, G))
    plain = time_ms(torch, lambda: h2_plain(fb, w), iters=3)
    nbytes = (fb.numel() * 2 + fb.numel() // E * F_cls * 2 + 2 * TIME_BATCH * E * 4
              + E * F_cls * 2)
    flops = 2 * fb.numel() * F_cls + 6 * fb.numel()
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log(f"    x1/forward: kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms:.4f} ms")
    table["K-H2"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, err32=e32, err16=e16)
    del fb, x, e

    # ---- 4. backward kernels against their plain versions ----
    phase("backward kernels vs plain versions (check at batch 2, time at batch 8, bf16)")

    # K-A' at each attention geometry of the model, without and with dropout
    kab = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, err32=0.0, err16=0.0, abs32=0.0,
               bytes=0.0, flops=0.0, ms_drop=0.0, plain_ms_drop=0.0, library_ms_drop=0.0,
               err32_drop=0.0, err16_drop=0.0, abs32_drop=0.0)

    def make_bwd(L, Cb):
        def make(B, dtype):
            qkv = randn(B, L, 6 * Cb, scale=0.5, dtype=dtype)  # branch slices
            return (qkv[..., :Cb], qkv[..., 2 * Cb:3 * Cb], qkv[..., 4 * Cb:5 * Cb],
                    randn(3, 3, 1, Cb, scale=1 / 3, dtype=dtype), randn(B, L, Cb, dtype=dtype))
        return make

    def check_bwd(name, kw, make):
        return check_outputs(
            name, torch,
            lambda q, k, v, w, g: stripe_attention.attention_bwd(q, k, v, w, g, **kw),
            lambda q, k, v, w, g: attention.stripe_attention_bwd_reference(
                q, k, v, w, g, **kw), make)

    for (reso, Cb, heads, hsp, wsp), count in sorted(geoms.items()):
        L = reso * reso
        kw = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads)
        kwd = dict(kw, attn_drop=DROP, seed=DROP_SEED)
        make = make_bwd(L, Cb)
        name = f"K-A' reso {reso} window {hsp}x{wsp} Cb {Cb} heads {heads}"
        e32, e16, a32 = check_bwd(name, kw, make)
        d32, d16, da32 = check_bwd(name + " dropout 0.3", kwd, make)
        q, k, v, w, g = make(TIME_BATCH, torch.bfloat16)
        ms = time_ms(torch, lambda: stripe_attention.attention_bwd(q, k, v, w, g, **kw))
        ms_drop = time_ms(torch, lambda: stripe_attention.attention_bwd(q, k, v, w, g, **kwd))
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
            # is timed on that one graph
            sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, dropout_p=p_drop,
                                                      scale=D ** -0.5)
            libs.append(time_ms(torch, lambda: torch.autograd.grad(
                sdpa_out, (qh, kh, vh), gh, retain_graph=True)))
            del sdpa_out
        lib, lib_drop = libs
        del qh, kh, vh, gh
        nbytes = 7 * TIME_BATCH * L * Cb * 2 + Cb * 9 * 4 * 2
        flops = (10 * N + 36) * TIME_BATCH * L * Cb
        b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
        log(f"    x{count}/step: kernel {ms:.4f} ms (dropout 0.3: {ms_drop:.4f})  plain "
            f"{plain:.4f} ms ({plain_drop:.4f})  sdpa bwd {lib:.4f} ms ({lib_drop:.4f})  "
            f"bound {b_ms:.4f} ms")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bytes", nbytes), ("flops", flops), ("ms_drop", ms_drop),
                         ("plain_ms_drop", plain_drop), ("library_ms_drop", lib_drop)):
            kab[key] += count * val
        for key, val in (("err32", e32), ("err16", e16), ("abs32", a32), ("err32_drop", d32),
                         ("err16_drop", d16), ("abs32_drop", da32)):
            kab[key] = max(kab[key], val)
    kab["bound_ms"], kab["bound_by"] = bound_ms(kab["bytes"], kab["flops"], "bfloat16")
    for (reso, Cb, heads, hsp, wsp), _ in sorted(geoms448.items()):
        kwd = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads, attn_drop=DROP,
                   seed=DROP_SEED)
        d32, d16, da32 = check_bwd(
            f"K-A' 448^2 reso {reso} window {hsp}x{wsp} Cb {Cb} heads {heads} dropout 0.3",
            kwd, make_bwd(reso * reso, Cb))
        for key, val in (("err32_drop", d32), ("err16_drop", d16), ("abs32_drop", da32)):
            kab[key] = max(kab[key], val)
    table["K-A'"] = kab

    # K-C' at the three decoder CARAFEs
    kcb = dict(ms=0.0, plain_ms=0.0, err32=0.0, err16=0.0, abs32=0.0, bytes=0.0, flops=0.0)
    for i, mod in enumerate(ups):
        C = mod.out.weight.shape[0]
        reso = IMG // 4 // 2 ** (len(ups) - i)
        S = mod.up_factor

        def make(B, dtype, reso=reso, C=C, S=S):
            return (randn(B, reso, reso, C, dtype=dtype),
                    randn(B, reso, reso, 9 * S * S, dtype=dtype),
                    randn(B, reso, reso, S * S * C, dtype=dtype))

        e32, e16, a32 = check_outputs(
            f"K-C' x ({reso},{reso},{C}) S {S}", torch,
            lambda x, e, d, S=S: carafe_kernels.carafe_flat_bwd(x, e, d, S),
            lambda x, e, d, S=S: carafe.carafe_bwd_reference(x, e, d, S), make)
        x, e, d = make(TIME_BATCH, torch.bfloat16)
        ms = time_ms(torch, lambda: carafe_kernels.carafe_flat_bwd(x, e, d, S))
        plain = time_ms(torch, lambda: carafe.carafe_bwd_reference(x, e, d, S), iters=3)
        nbytes = (2 * x.numel() + 2 * e.numel() + d.numel()) * 2
        flops = 6 * 9 * d.numel()
        b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
        log(f"    x1/step: kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms:.4f} ms")
        for key, val in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes),
                         ("flops", flops)):
            kcb[key] += val
        kcb["err32"] = max(kcb["err32"], e32)
        kcb["err16"] = max(kcb["err16"], e16)
        kcb["abs32"] = max(kcb["abs32"], a32)
    kcb["bound_ms"], kcb["bound_by"] = bound_ms(kcb["bytes"], kcb["flops"], "bfloat16")
    kcb["library_ms"] = None
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
        make_head)
    fb, dy, mu, v, w = make_head(TIME_BATCH, torch.bfloat16)
    ms = time_ms(torch, lambda: carafe_head.head_bwd1(fb, dy, mu, v, w, G))
    plain = time_ms(torch, lambda: carafe_head.head_bwd1_reference(fb, dy, mu, v, w, G),
                    iters=3)
    nbytes = (fb.numel() + dy.numel()) * 2 + 4 * TIME_BATCH * E * 4 + E * F_cls * 8
    flops = (16 + 4 * F_cls) * fb.numel()
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log(f"    x1/step: kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms:.4f} ms")
    table["K3"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
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
        lambda *a: carafe_head.fused_head_bwd_reference(*a, S_HEAD), make_k4)
    args = make_k4(TIME_BATCH, torch.bfloat16)
    ms = time_ms(torch, lambda: carafe_head.fused_head_bwd(*args, S_HEAD))
    plain = time_ms(torch, lambda: carafe_head.fused_head_bwd_reference(*args, S_HEAD),
                    iters=3)
    x, e, fb, dy = args[:4]
    nbytes = ((2 * x.numel() + 2 * e.numel() + fb.numel() + dy.numel()) * 2
              + 4 * TIME_BATCH * E * 4 + E * F_cls * 2 + E * 4)
    flops = 6 * 9 * fb.numel() + 16 * fb.numel()
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log(f"    x1/step: kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms:.4f} ms")
    table["K4"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, err32=e32, err16=e16, abs32=a32)
    del args, x, e, fb, dy

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
                                                          gate=False)[2:], make_ng)
    fb, dy, w = make_ng(B448, torch.float32)
    ms = time_ms(torch, lambda: carafe_head.head_bwd1(fb, dy, None, None, w, G, gate=False))
    plain = time_ms(torch, lambda: carafe_head.head_bwd1_reference(fb, dy, None, None, w, G,
                                                                   gate=False), iters=3)
    nbytes = (fb.numel() + dy.numel()) * 4 + E * F_cls * 4
    flops = 2 * F_cls * fb.numel()
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    log(f"    x1/step (batch {B448}, float32): kernel {ms:.4f} ms  plain {plain:.4f} ms  "
        f"bound {b_ms:.4f} ms")
    table["K3 no gate"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
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
                                  make_k4ng)
    args = make_k4ng(B448, torch.float32)
    ms = time_ms(torch, lambda: k4ng(*args))
    plain = time_ms(torch, lambda: k4ng_plain(*args), iters=3)
    x, e, _, dy, _ = args
    nbytes = (2 * x.numel() + 2 * e.numel() + dy.numel()) * 4 + E * F_cls * 4 + E * 4
    flops = 6 * 9 * x.numel() * G + 2 * F_cls * x.numel() * G
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    log(f"    x1/step (batch {B448}, float32): kernel {ms:.4f} ms  plain {plain:.4f} ms  "
        f"bound {b_ms:.4f} ms")
    table["K4 no gate"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                               library_ms=None, err32=e32, err16=e16, abs32=a32)
    del args, x, e, fb, dy
    torch.cuda.empty_cache()

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
    log(f"launches over requests of batch 1, 3, 8, 11: {launches}")
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

    _build.reset_launches()
    server(requests[2])
    torch.cuda.synchronize()
    batch8 = {k: n for k, n in _build.LAUNCHES.items() if n}
    log(f"launches of one batch-8 request: {batch8}")
    require(batch8 == per_forward, f"batch-8 launches {batch8} != {per_forward}")

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


    # ---- 6. training ----
    per_step = {**per_forward, stripe_attention.BWD_KERNEL: per_forward[stripe_attention.KERNEL],
                carafe_kernels.BWD_KERNEL: per_forward[carafe_kernels.KERNEL],
                carafe_head.BWD1_KERNEL: 1, carafe_head.FUSED_BWD_KERNEL: 1}
    n_attn448 = len([m for m in model448.modules() if isinstance(m, LePEAttention)])
    per_step448 = {stripe_attention.KERNEL: n_attn448, stripe_attention.BWD_KERNEL: n_attn448,
                   carafe_kernels.KERNEL: len(ups), carafe_kernels.BWD_KERNEL: len(ups),
                   carafe_head.MOMENTS_KERNEL: 1, carafe_head.HEAD_KERNEL: 1,
                   carafe_head.BWD1_NOGATE_KERNEL: 1, carafe_head.FUSED_BWD_NOGATE_KERNEL: 1}
    model0 = build_model("cswin_simam_512", device=dev, seed=SEED, **NO_DROPS)
    runs = {}
    for label, net, cfg_name, want_step in (
            ("cswin_simam_512 drops 0.3", model, "cswin_simam_512", per_step),
            ("cswin_simam_512 drops 0", model0, "cswin_simam_512", per_step),
            ("cswinunet drops 0.3", model448, "cswinunet", per_step448)):
        runs[label] = train_phase(torch, engine, _build, label, net, TRAIN_CONFIGS[cfg_name],
                                  want_step, dev)
    del model0
    train_launches = runs["cswin_simam_512 drops 0.3"]["launches"]
    train_launches448 = runs["cswinunet drops 0.3"]["launches"]

    # kernels on against kernels off, one batch-2 step from the same weights
    # and the same dropout seed (so the same masks)
    def grads_of(net, use_kernels, images_d, masks_d):
        net.zero_grad(set_to_none=True)
        loss, _, _ = engine.compute_gradients(net, images_d[:CHECK_BATCH],
                                              masks_d[:CHECK_BATCH], 1, use_kernels,
                                              rng=DROP_SEED)
        grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        return float(loss), grads

    def compare_f32(label, net, img):
        images_d, masks_d = disc_batch(torch, img, CHECK_BATCH, dev)
        loss_on, g_on = grads_of(net, True, images_d, masks_d)
        loss_off, g_off = grads_of(net, False, images_d, masks_d)
        worst_name, worst = "", 0.0
        for name, g in g_off.items():
            rel = float((g_on[name] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            if rel > worst:
                worst_name, worst = name, rel
            require(rel <= TOL_GRAD_F32, f"{label}: float32 gradient of {name}: rel gap {rel}")
        log(f"gradients, kernels on vs off, {label}, float32, batch {CHECK_BATCH}, dropout "
            f"seed {DROP_SEED}: loss {loss_on:.6f} vs {loss_off:.6f}; largest gap "
            f"{worst:.3e} x max|g| ({worst_name}) over {len(g_off)} parameters "
            f"(tol {TOL_GRAD_F32:g})")
        return worst

    phase("gradients, kernels on vs off, drops 0.3, one dropout seed")
    grad_gap = compare_f32("cswin_simam_512 drops 0.3", model32, IMG)
    del model32
    grad_gap448 = compare_f32("cswinunet drops 0.3", model448, IMG448)
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

    # ---- 7. results ----
    sources = {
        "K-A": ("csu_stripe_attention_fwd", "cswin_simam_unet_tpu_torch/csrc/stripe_attention.cu",
                "cswin_simam_unet_tpu/ops/pallas_attention_v2.py:180"),
        "K-C": ("csu_carafe_fwd", "cswin_simam_unet_tpu_torch/csrc/carafe.cu",
                "cswin_simam_unet_tpu/ops/pallas_carafe.py:176"),
        "K-H1": ("csu_carafe_head_fwd", "cswin_simam_unet_tpu_torch/csrc/carafe.cu",
                 "cswin_simam_unet_tpu/ops/pallas_carafe_head.py:76"),
        "K-H2": ("csu_simam_head_fwd", "cswin_simam_unet_tpu_torch/csrc/simam_head.cu",
                 "cswin_simam_unet_tpu/ops/pallas_simam_head.py:109"),
        "K-A'": ("csu_stripe_attention_bwd",
                 "cswin_simam_unet_tpu_torch/csrc/stripe_attention_bwd.cu",
                 "cswin_simam_unet_tpu/ops/pallas_attention_v2.py:219"),
        "K-C'": ("csu_carafe_bwd", "cswin_simam_unet_tpu_torch/csrc/carafe.cu",
                 "cswin_simam_unet_tpu/ops/pallas_carafe.py:196"),
        "K3": ("csu_head_bwd1", "cswin_simam_unet_tpu_torch/csrc/simam_head.cu",
               "cswin_simam_unet_tpu/ops/pallas_simam_head.py:124"),
        "K4": ("csu_carafe_head_bwd", "cswin_simam_unet_tpu_torch/csrc/carafe.cu",
               "cswin_simam_unet_tpu/ops/pallas_carafe_head.py:163"),
        "K3 no gate": ("csu_head_bwd1_nogate", "cswin_simam_unet_tpu_torch/csrc/simam_head.cu",
                       "cswin_simam_unet_tpu/ops/pallas_simam_head.py:178"),
        "K4 no gate": ("csu_carafe_head_bwd_nogate",
                       "cswin_simam_unet_tpu_torch/csrc/carafe.cu",
                       "cswin_simam_unet_tpu/ops/pallas_carafe_head.py:163"),
    }
    kernels = []
    for label, (fn, src, replaces) in sources.items():
        row = table[label]
        # launches: one training step of the path that runs the kernel
        # (cswin_simam_512 at drops 0.3, or cswinunet for the two without gate)
        path = train_launches if train_launches.get(fn) else train_launches448
        entry = {
            "name": f"{label} {fn}", "route": "cuda", "source": src, "replaces": replaces,
            "launches": path[fn], "launches_cswinunet_step": train_launches448.get(fn, 0),
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
        kernels.append(entry)
    log("training: " + json.dumps({k: {m: v for m, v in r.items() if m != "launches"}
                                   for k, r in runs.items()}))
    log(f"f32 gradient gaps, kernels on vs off at drops 0.3: cswin_simam_512 {grad_gap:.3e}, "
        f"cswinunet {grad_gap448:.3e}; K-A keep rate {table['K-A']['keep_rate']:.6f}")
    log(f"build {build_s:.1f} s, whole run {time.perf_counter() - T_START:.1f} s")
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
