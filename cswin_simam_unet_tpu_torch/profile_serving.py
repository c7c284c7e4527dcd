"""Where the time of serving goes on the card.

    python -m cswin_simam_unet_tpu_torch.profile_serving [--batch 8] [--steps 5] [--repeats 3]

Builds the served configuration (``cswin_simam_512``, random weights from
seed 0) and warms up.  Then, ``--repeats`` times, it times ``--steps``
forwards of one ``--batch`` request on the host clock, untraced, and right
after traces ``--steps`` more under ``torch.profiler`` (device activity
only).  For each traced window it prints the device's busy and idle share of
that same window: the window runs from the start of its first device
activity to the end of its last, and busy time is the union of the activity
intervals inside it.  Tracing slows the host, so that idle share overstates
the untraced one.  The script therefore also prints the traced window's
host time beside the untraced loop's, and the idle share of the untraced
loop's wall time, ``1 - busy / untraced wall``, with busy time from the
trace that follows it (tracing slows the host, not the kernels).  Last, the
device time per forward by kernel group (the port's kernels, matrix
products, the rest) and the launches per forward.  Needs a CUDA device.
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
        return "port kernels (" + name.split("csu::")[1].split("<")[0] + ")"
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies between host and device, memsets"
    if "gemm" in low or "nvjet" in low or "sm90_xmma" in low or "cutlass" in low or "ampere" in low:
        return "matrix products (cuBLAS)"
    if "conv" in low or "cudnn" in low or "implicit" in low:
        return "convolutions (cuDNN)"
    if "reduce" in low:
        return "reductions (norms, SimAM statistics)"
    if "elementwise" in low or "vectorized" in low or "copy" in low:
        return "elementwise and copies"
    return "other"


def main() -> None:
    from .configs import build_model
    from .serving import Server

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    model = build_model("cswin_simam_512")
    server = Server(model)
    images = np.random.RandomState(0).randint(0, 256, (args.batch, 512, 512, 3), np.uint8)
    for _ in range(3):
        server(images)
    windows = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            server(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.steps * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                server(images)
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

    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"batch {args.batch}, {args.steps} forwards per window, ms per forward:")
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
    print(f"last window: {len(events) / args.steps:.0f} device activities per forward; "
          "device ms per forward by group:")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / args.steps / 1e3:9.4f}  {g}")
    print("top kernels (device ms per forward, launches per forward):")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, n) in top:
        print(f"  {us / args.steps / 1e3:9.4f}  {n / args.steps:5.0f}  {name[:110]}")
    print(json.dumps({
        "batch": args.batch,
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
