#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the exit code is non-zero:

1. environment: torch, CUDA, nvcc, and the card (nvidia-smi);
2. build: the kernels of ``cswin_simam_unet_tpu_torch/csrc`` (one nvcc);
3. each kernel (K-A, K-C, K-H1, K-H2) against its plain PyTorch version on
   the card at the serving path's shapes: float32 at batch 2 with a tight
   tolerance, bfloat16 at batch 2 against the plain version in float32 on
   the same bf16 values with a looser one; then its time, the plain
   version's time, the library call's time where one exists and the bound,
   all in bf16 at batch 8;
4. the slice: CSWin-SimAM-UNet at 512^2, full width, bf16, kernels on,
   random weights from a seed, served through ``Server`` for requests of
   batch 1, 3, 8 and 11 (launch counts reset before and read after); output
   checks; kernels-on against kernels-off in bf16 (batch 2) and float32
   (batch 1); the launch counts of one batch-8 request; ms per batch-8
   request and images/s.

The last two lines are the kernel table as JSON and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
port next to this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

IMG = 512
SEED = 0
TIME_BATCH = 8                      # kernels timed at the served bucket
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,   # dense bf16 tensor cores
              "float32": 67e12}     # float32 outside the tensor cores
TOL_F32 = 1e-4                      # max |kernel - plain|, float32 inputs
TOL_BF16 = 2e-2                     # x max(1, max|plain|), bf16 inputs
TOL_STATS = 1e-4                    # x (1 + |plain|), K-H1 pooled moments
TOL_MODEL_BF16 = 5e-2               # probabilities, kernels on vs off, bf16
TOL_MODEL_F32 = 1e-3                # probabilities, kernels on vs off, f32


def log(*args) -> None:
    print(*args, flush=True)


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr, flush=True)
        return 1
    import torch.nn.functional as F
    from cswin_simam_unet_tpu_torch import _build
    from cswin_simam_unet_tpu_torch.configs import build_model
    from cswin_simam_unet_tpu_torch.models.layers import CARAFE, LePEAttention
    from cswin_simam_unet_tpu_torch.ops import attention, carafe, carafe_head
    from cswin_simam_unet_tpu_torch.ops import carafe_kernels, stripe_attention
    from cswin_simam_unet_tpu_torch.ops.simam import pooled_stats
    from cswin_simam_unet_tpu_torch.serving import Server

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. environment ----
    log("== environment")
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
    log("== build")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    info = _build.build_info
    log(f"built {info['path']} in {build_s:.1f} s (nvcc {info['seconds']:.1f} s, "
        f"cached={info['cached']})")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    model = build_model("cswin_simam_512", device=dev, seed=SEED)
    table = {}

    # ---- 3. kernels against their plain versions ----
    log("== kernels vs plain versions (check at batch 2, time at batch 8, bf16)")

    # K-A at each attention geometry of the model
    geoms: dict = {}
    for mod in model.modules():
        if isinstance(mod, LePEAttention):
            key = (mod.resolution, mod.get_v.weight.shape[0], mod.num_heads,
                   mod.hsp, mod.wsp)
            geoms[key] = geoms.get(key, 0) + 1
    ka = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err32=0.0,
              err16=0.0, bytes=0.0, flops=0.0)
    for (reso, Cb, heads, hsp, wsp), count in sorted(geoms.items()):
        L = reso * reso
        kw = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads)

        def make(B, dtype, L=L, Cb=Cb):
            qkv = randn(B, L, 6 * Cb, scale=0.5, dtype=dtype)  # branch slices
            return (qkv[..., :Cb], qkv[..., 2 * Cb:3 * Cb], qkv[..., 4 * Cb:5 * Cb],
                    randn(3, 3, 1, Cb, scale=1 / 3, dtype=dtype))

        e32, e16 = check_pair(f"K-A reso {reso} window {hsp}x{wsp} Cb {Cb} heads {heads}",
                              torch,
                              lambda q, k, v, w, kw=kw: stripe_attention.stripe_attention(
                                  q, k, v, w, **kw),
                              lambda q, k, v, w, kw=kw: attention.stripe_attention(
                                  q, k, v, w, **kw), make)
        q, k, v, w = make(TIME_BATCH, torch.bfloat16)
        ms = time_ms(torch, lambda: stripe_attention.stripe_attention(q, k, v, w, **kw))
        plain = time_ms(torch, lambda: attention.stripe_attention(q, k, v, w, **kw), iters=3)
        D, N = Cb // heads, hsp * wsp

        def win_heads(t):
            return attention.window_heads(t, hsp, wsp, reso, reso, heads).contiguous()

        qh, kh, vh = win_heads(q), win_heads(k), win_heads(v)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=D ** -0.5))
        nbytes = 4 * TIME_BATCH * L * Cb * 2 + Cb * 9 * 4
        flops = (4 * N + 18) * TIME_BATCH * L * Cb
        b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
        log(f"    x{count}/forward: kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"sdpa {lib:.4f} ms  bound {b_ms:.4f} ms")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bytes", nbytes), ("flops", flops)):
            ka[key] += count * val
        ka["err32"] = max(ka["err32"], e32)
        ka["err16"] = max(ka["err16"], e16)
    ka["bound_ms"], ka["bound_by"] = bound_ms(ka["bytes"], ka["flops"], "bfloat16")
    table["K-A"] = ka

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

    # ---- 4. the slice ----
    log("== serving CSWin-SimAM-UNet 512^2 bf16, kernels on")
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
    batch8 = dict(_build.LAUNCHES)
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
    del model32, on, off

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

    # ---- 5. results ----
    sources = {
        "K-A": ("csu_stripe_attention_fwd", "cswin_simam_unet_tpu_torch/csrc/stripe_attention.cu",
                "cswin_simam_unet_tpu/ops/pallas_attention_v2.py:180"),
        "K-C": ("csu_carafe_fwd", "cswin_simam_unet_tpu_torch/csrc/carafe.cu",
                "cswin_simam_unet_tpu/ops/pallas_carafe.py:176"),
        "K-H1": ("csu_carafe_head_fwd", "cswin_simam_unet_tpu_torch/csrc/carafe.cu",
                 "cswin_simam_unet_tpu/ops/pallas_carafe_head.py:76"),
        "K-H2": ("csu_simam_head_fwd", "cswin_simam_unet_tpu_torch/csrc/simam_head.cu",
                 "cswin_simam_unet_tpu/ops/pallas_simam_head.py:109"),
    }
    kernels = []
    for label, (fn, src, replaces) in sources.items():
        row = table[label]
        kernels.append({
            "name": f"{label} {fn}", "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[fn], "launches_per_forward": batch8[fn],
            "max_abs_err": row["err32"], "max_abs_err_bf16": row["err16"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "pass": True,
        })
    log(f"build {build_s:.1f} s, whole run {time.perf_counter() - t_start:.1f} s")
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
