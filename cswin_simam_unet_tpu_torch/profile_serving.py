"""Where the time of serving, or of a training step, goes on the card.

    python -m cswin_simam_unet_tpu_torch.profile_serving [--batch 8] [--steps 5] [--repeats 3]
        [--train] [--config cswin_simam_512] [--no-drops] [--no-tf32]

Builds the configuration (``--config``, default ``cswin_simam_512``, random
weights from seed 0; ``--no-drops`` sets its dropout, attention dropout and
drop-path rates to 0, which only training uses; ``--no-tf32`` keeps cuDNN's
float32 convolutions off TF32) and warms up.  Then, ``--repeats``
times, it times ``--steps`` forwards of one ``--batch`` request (with
``--train``: training steps of ``make_train_step`` with the
configuration's optimizer settings, classes and ``grad_accum`` on one
uint8 batch; the UNet configs too, whose device time is cuDNN's
convolutions and the elementwise passes, no port kernel) on the host
clock, untraced, and right after traces ``--steps`` more under
``torch.profiler`` (device activity only).  For each traced window it
prints the device's busy and idle share of that same window: the window
runs from the start of its first device activity to the end of its last,
and busy time is the union of the activity intervals inside it.  Tracing
slows the host, so that idle share overstates the untraced one.  The
script therefore also prints the traced window's
host time beside the untraced loop's, and the idle share of the untraced
loop's wall time, ``1 - busy / untraced wall``, with busy time from the
trace that follows it (tracing slows the host, not the kernels).  Last, the
device time per forward (or step) by kernel group (the port's kernels,
matrix products, the rest) and the launches per forward (or step).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch


def _group(name: str) -> str:
    if "csu::" in name:
        kernel = name.split("csu::")[1].split("<")[0]
        # K-C' and K-C run on K4's and K-H1's kernels: told apart by their
        # template arguments (the CopyDacc policy; no bias, no moments)
        if "CopyDacc" in name:
            kernel += ", K-C'"
        elif kernel == "carafe_head_fwd_kernel" and ", false, false>" in name:
            kernel += ", K-C"
        return "port kernels (" + kernel + ")"
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies between host and device, memsets"
    if "batch_norm" in low or "bn_fw" in low or "bn_bw" in low:
        return "BatchNorm"
    # cuDNN's convolutions: implicit GEMMs (fprop, dgrad, wgrad) and, for
    # strict float32 under its default heuristics, FFTs with complex GEMMs
    if any(k in low for k in ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad", "fft",
                              "cf32")):
        return "convolutions (cuDNN)"
    if "gemm" in low or "nvjet" in low or "sm90_xmma" in low or "cutlass" in low or "ampere" in low:
        return "matrix products (cuBLAS)"
    if "multi_tensor_apply" in low:
        return "optimizer (AdamW, foreach)"
    if "reduce" in low:
        return "reductions (norms, SimAM statistics)"
    if "elementwise" in low or "vectorized" in low or "copy" in low:
        return "elementwise and copies"
    return "other"


def main() -> None:
    from .configs import CONFIGS, NO_DROPS, TRAIN_CONFIGS, build_model
    from .serving import Server
    from .train import engine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--train", action="store_true", help="profile training steps")
    ap.add_argument("--config", default="cswin_simam_512")
    ap.add_argument("--no-drops", action="store_true", help="dropout rates 0")
    ap.add_argument("--no-tf32", action="store_true",
                    help="cuDNN's float32 convolutions without TF32 (torch's default allows it)")
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = not args.no_tf32

    model = build_model(args.config, **(NO_DROPS if args.no_drops else {}))
    img = CONFIGS[args.config].img_size
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (args.batch, img, img, 3), np.uint8)
    if args.train:
        tcfg = TRAIN_CONFIGS[args.config]
        opt = engine.make_optimizer(tcfg.optimizer, tcfg.learning_rate, tcfg.weight_decay,
                                    model.parameters())
        n_classes = model.num_classes
        step = engine.make_train_step(model, opt, n_classes, grad_accum=tcfg.grad_accum)
        images_d = torch.from_numpy(images).cuda()
        # class ids, or 0/255 for the binary head
        masks = rs.randint(0, max(n_classes, 2), (args.batch, img, img, 1))
        masks_d = torch.from_numpy(
            (masks if n_classes > 1 else masks * 255).astype(np.uint8)).cuda()

        def run():
            step(images_d, masks_d)
    else:
        server = Server(model)

        def run():
            server(images)
    for _ in range(3):
        run()
    windows = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.steps * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                run()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) / args.steps * 1e3
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events:
            raise RuntimeError("the profiler recorded no device activity")
        span_us, busy_us = _span_and_busy(
            [(e.time_range.start, e.time_range.end) for e in events])
        busy_ms = busy_us / args.steps / 1e3
        windows.append(dict(untraced_wall_ms=wall_ms, traced_wall_ms=traced_ms,
                            span_ms=span_us / args.steps / 1e3, busy_ms=busy_ms,
                            idle_share=1 - busy_us / span_us,
                            untraced_idle_share=1 - busy_ms / wall_ms,
                            events=events))

    print(f"card: {torch.cuda.get_device_name(0)}; {args.config}, drop rates "
          f"{getattr(model, 'drop_rates', 'none (UNet)')}, {model.dtype}; cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32}")
    unit = "training step" if args.train else "forward"
    print(f"batch {args.batch}, {args.steps} {unit}s per window, ms per {unit}:")
    for i, w in enumerate(windows):
        print(f"window {i}: untraced host {w['untraced_wall_ms']:.3f}; traced host "
              f"{w['traced_wall_ms']:.3f}, device span {w['span_ms']:.3f}, busy "
              f"{w['busy_ms']:.3f}, idle share {w['idle_share']:.4f}; idle share of the "
              f"untraced wall {w['untraced_idle_share']:.4f}")

    events = windows[-1]["events"]
    by_group: dict = collections.defaultdict(float)
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        us = e.time_range.elapsed_us()
        by_group[_group(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    print(f"last window: {len(events) / args.steps:.0f} device activities per {unit}; "
          f"device ms per {unit} by group:")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / args.steps / 1e3:9.4f}  {g}")
    print(f"top kernels (device ms per {unit}, launches per {unit}):")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, n) in top:
        print(f"  {us / args.steps / 1e3:9.4f}  {n / args.steps:5.0f}  {name[:110]}")
    print(json.dumps({
        "batch": args.batch, "unit": unit,
        "windows": [{k: v for k, v in w.items() if k != "events"} for w in windows],
        "activities_per_forward": len(events) / args.steps,
        "groups_ms": {g: us / args.steps / 1e3 for g, us in by_group.items()}}))


def _span_and_busy(intervals: list) -> tuple[float, float]:
    """(last end - first start, length of the union) of (start, end) pairs."""
    intervals = sorted(intervals)
    busy, cur_start, cur_end = 0.0, intervals[0][0], intervals[0][1]
    for start, end in intervals[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return max(end for _, end in intervals) - intervals[0][0], busy


if __name__ == "__main__":
    main()
