"""K3 and K4 against variants of themselves on the card.

    python -m cswin_simam_unet_tpu_torch.head_bwd_variants [--only NAME ...]

Each variant is a copy of this package under ``build/head_bwd_variants/``
with one change to K3's or K4's source (or launch geometry), built there
and timed in a process of its own: the device time of ``head_bwd1`` (K3
and the sum of its partials) and of ``fused_head_bwd`` (K4 and the sum of
its db partials), and of each kernel's launch alone, behind a spin kernel,
at the 512^2 head (batch 8) and the 2048^2 head (batch 1), bf16, one
class; and each variant's largest error over max|plain| at the 512^2 head
(batch 1).  The variants say what the design choices are worth: the
branch-free correctly rounded division and reciprocal against ``/``,
predicated against branched loads, the share of K4's time that staging
takes, and other block shapes.  Needs a CUDA device; prints one JSON line
per variant.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent / "build" / "head_bwd_variants"
K3_SRC, K4_SRC, PY = "csrc/simam_head.cu", "csrc/carafe_head_bwd.cu", "ops/carafe_head.py"

# name -> [(file in the package, text, replacement)]
VARIANTS = {
    "as built": [],
    "K3 gate with /": [
        (K3_SRC, "div_rn_by(xc * xc, den[i], rden[i]) + 0.5f", "xc * xc / den[i] + 0.5f"),
        (K3_SRC, "rcp_rn(1.f + expf(-e))", "1.f / (1.f + expf(-e))")],
    "K4 sigmoid with /": [
        (K4_SRC, "rcp_rn(1.f + expf(-(xc * xc * w4[i] + 0.5f)))",
         "1.f / (1.f + expf(-(xc * xc * w4[i] + 0.5f)))")],
    "K4 dp taps branched": [
        (K4_SRC, "            const bool in = yy >= 0 && yy < H && xn >= 0 && xn < W;\n",
         "            if (yy < 0 || yy >= H || xn < 0 || xn >= W) continue;\n"
         "            const bool in = true;\n")],
    "K4 staging only (outputs wrong)": [(K4_SRC, "    process(y);\n", "\n")],
    "K4 strips of 4 columns": [(PY, "K4_PX = (8, 4, 2, 1)", "K4_PX = (4, 2, 1)")],
    "K4 runs of at most 8 rows": [(PY, "K4_ROWS = (32, 16, 8, 4, 2, 1)",
                                   "K4_ROWS = (8, 4, 2, 1)")],
}

CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from cswin_simam_unet_tpu_torch import _build
from cswin_simam_unet_tpu_torch.ops import carafe_head
from cswin_simam_unet_tpu_torch.ops.simam import LAMBDA, pooled_stats

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)


def randn(*shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)


def device_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)  # the calls queue behind it: no host time
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


out, G, E, F = {}, 16, 64, 1
sms = torch.cuda.get_device_properties(0).multi_processor_count
for label, B, r in (("512", 8, 128), ("2048", 1, 512)):
    fb, dy = randn(B, r, r, G * E), randn(B, r, r, G * F)
    f = fb.float()
    mu, v = pooled_stats(f.sum((1, 2)), (f * f).sum((1, 2)), r * r * G, G)
    del f
    w = randn(E, F, scale=E ** -0.5, dtype=torch.float32)
    wt = w.to(fb.dtype)
    x, enc = randn(B, r, r, E), randn(B, r, r, 9 * G)
    A, Bq, _ = carafe_head.head_bwd1(fb, dy, mu, v, w, G)
    out[f"K3 {label}"] = device_ms(lambda: carafe_head.head_bwd1(fb, dy, mu, v, w, G))
    out[f"K4 {label}"] = device_ms(
        lambda: carafe_head.fused_head_bwd(x, enc, fb, dy, mu, v, A, Bq, w, 4))
    g3 = carafe_head.k3_geometry(B, r, r, sms)
    part = torch.empty(g3["blocks"], (2 + F) * G * E, device=dev)
    out[f"K3 kernel {label}"] = device_ms(lambda: _build.launch(
        carafe_head.BWD1_KERNEL, dev, 1, fb.data_ptr(), dy.data_ptr(), mu.data_ptr(),
        v.data_ptr(), wt.data_ptr(), part.data_ptr(), B, r, r, E, G, F, 8, LAMBDA,
        g3["pixels"]))
    g4 = carafe_head.k4_geometry(B, r, r, E, 4, 8, 2, F, True, sms)
    db, dx, denc = (torch.empty(g4["blocks"], G * E, device=dev), torch.empty_like(x),
                    torch.empty_like(enc))
    out[f"K4 kernel {label}"] = device_ms(lambda: _build.launch(
        carafe_head.FUSED_BWD_KERNEL, dev, 1, x.data_ptr(), enc.data_ptr(), fb.data_ptr(),
        dy.data_ptr(), wt.data_ptr(), mu.data_ptr(), v.data_ptr(), A.data_ptr(),
        Bq.data_ptr(), dx.data_ptr(), denc.data_ptr(), db.data_ptr(), B, r, r, E, 4, F, 8,
        g4["px"], g4["rows"], LAMBDA))
    if label == "512":  # errors over max|plain| of each output, batch 1
        x1, e1, fb1, dy1 = x[:1], enc[:1], fb[:1], dy[:1]
        f1 = fb1.float()
        mu1, v1 = pooled_stats(f1.sum((1, 2)), (f1 * f1).sum((1, 2)), r * r * G, G)
        got = carafe_head.head_bwd1(fb1, dy1, mu1, v1, w, G)
        want = carafe_head.head_bwd1_reference(f1, dy1.float(), mu1, v1, w, G)
        out["K3 error"] = max(float((a - b).abs().max() / b.abs().max())
                              for a, b in zip(got, want))
        got = carafe_head.fused_head_bwd(x1, e1, fb1, dy1, mu1, v1, want[0], want[1], w, 4)
        ref = carafe_head.fused_head_bwd_reference(x1.float(), e1.float(), f1, dy1.float(),
                                                   mu1, v1, want[0], want[1], w, 4)
        out["K4 error"] = max(float((a.float() - b).abs().max() / b.abs().max())
                              for a, b in zip(got, ref))
    del fb, dy, x, enc
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def make_copy(name: str, patches) -> Path:
    root = ROOT / name.replace(" ", "_").replace("/", "div").replace("(", "").replace(")", "")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    for rel, text, new in patches:
        path = root / PKG.name / rel
        src = path.read_text()
        if src.count(text) != 1:
            raise RuntimeError(f"{name}: {text!r} is not once in {rel}")
        path.write_text(src.replace(text, new))
    return root


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", help="variant names to run (default: all)")
    args = ap.parse_args()
    names = args.only or list(VARIANTS)
    failed = 0
    for name in names:  # one after the other: each builds and times alone on the card
        root = make_copy(name, VARIANTS[name])
        run = subprocess.run([sys.executable, "-c", CHILD, str(root)], capture_output=True,
                             text=True, timeout=900, env={**os.environ, "PYTHONPATH": ""})
        lines = [l for l in run.stdout.splitlines() if l.startswith("RESULT ")]
        if run.returncode or not lines:
            failed += 1
            print(json.dumps({"variant": name, "failed": run.stderr[-2000:]}), flush=True)
            continue
        print(json.dumps({"variant": name, **json.loads(lines[0][7:])}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
