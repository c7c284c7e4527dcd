"""The fused head's four kernels, K3 and K4 (backward) and K-H1 and K-H2
(forward), the standalone head's K5 (with and without the gate), and the
decoder's CARAFE kernels on K4's and K-H1's bodies, K-C' and K-C, against
variants of themselves on the card.

    python -m cswin_simam_unet_tpu_torch.head_bwd_variants [--only NAME ...]
        [--baseline DIR]

Each variant is a copy of this package under ``build/head_bwd_variants/``
with one change to a kernel's source (or launch geometry), built there and
timed in a process of its own, behind a spin kernel: the device time of
``head_bwd1`` (K3 and the sum of its partials), ``fused_head_bwd`` (K4 and
the sum of its db partials) and of each of their launches alone, at the
512^2 head (batch 8) and the 2048^2 head (batch 1), bf16, one class; of
``carafe_biased_moments`` (K-H1, with and without the moments) and
``simam_head_flat`` (K-H2), the wrappers' torch glue included, at the same
heads and at cswinunet's (448^2, batch 2, float32, no SimAM); K4 without
the gate at all three heads and with it at cswinunet's too; K5
(``simam_head.head_bwd2``, its db sum included) with and without the gate
at the three heads; K-C (``carafe_flat``) and K-C' (``carafe_flat_bwd``) summed over the three
decoder CARAFEs of the 512^2 (batch 8), 2048^2 (batch 1) and cswinunet
(448^2, batch 2, float32) models; and each variant's largest error over
max|plain| at the 512^2 head and decoder (batch 1).  The variants say what the design
choices are worth: the branch-free correctly rounded division and
reciprocal against ``/``, predicated against branched loads, the share of
K4's time that staging takes, and other block shapes.  ``--baseline DIR``
adds the variant ``baseline``, the package of the checkout at DIR (another
commit's tree, say) timed by the same measurements, so that ``--only
baseline "as built" "as built" baseline`` compares two trees in turns.
``--faults`` instead plants each of FAULTS (those named by ``--only``, or
all) in a copy of the package and runs the CARAFE and K5 card tests (``-k
SELECT``) and ``chip_smoke.py`` there, which must fail.  Needs a CUDA
device; prints one JSON line per variant or fault.
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
K5_SRC = K3_SRC
H2_SRC, H1_SRC = K3_SRC, "csrc/carafe_head_fwd.cu"
CK_PY = "ops/carafe_kernels.py"  # K-C and K-C' (on K-H1's and K4's bodies)

# K5's pixels in flight, its dx and its store, as the variants below rewrite them
K5_U = ("constexpr int U = FM <= 2 ? 4 : 2;  // pixels whose loads are in flight together\n"
        "  const int CV = C / VEC, GC = G * C;\n  int g, c;")
K5_DX = "dg = fmaf(-cb[i], xc, fmaf(dg, gv, 2.f * w4[i] * t * xc) - ca[i]);"
K5_STORE = "      store_vec_cs<T, VEC>(dx + (p0 + u0 + u) * GC + g * C + c, out);"

# name -> [(file in the package, text, replacement)]
VARIANTS = {
    "as built": [],
    "K3 gate with /": [
        (K3_SRC, "as / does\n        const float e = div_rn_by(xc * xc, den[i], rden[i]) + 0.5f",
         "as / does\n        const float e = xc * xc / den[i] + 0.5f"),
        (K3_SRC, "const float gt = rcp_rn(1.f + expf(-e))",
         "const float gt = 1.f / (1.f + expf(-e))")],
    "K4 sigmoid with /": [
        (K4_SRC, "rcp_rn(1.f + expf(-(xc * xc * w4[i] + 0.5f)))",
         "1.f / (1.f + expf(-(xc * xc * w4[i] + 0.5f)))")],
    "K4 dp taps branched": [
        (K4_SRC, "            const bool in = yy >= 0 && yy < H && xn >= 0 && xn < W;\n",
         "            if (yy < 0 || yy >= H || xn < 0 || xn >= W) continue;\n"
         "            const bool in = true;\n")],
    "K4 staging only (outputs wrong)": [(K4_SRC, "    process(y);\n", "\n")],  # K-C' too
    "K4 strips of 4 columns": [(PY, "K4_PX = (8, 4, 2, 1)", "K4_PX = (4, 2, 1)")],
    "K4 runs of at most 8 rows": [(PY, "K4_ROWS = (32, 16, 8, 4, 2, 1)",
                                   "K4_ROWS = (8, 4, 2, 1)")],
    "K-H2 gate with /": [
        (H2_SRC, "bit for bit\n            const float e = div_rn_by(xc * xc, den[i], rden[i])",
         "bit for bit\n            const float e = xc * xc / den[i]"),
        (H2_SRC, "y * rcp_rn(1.f + expf(-e))", "y * (1.f / (1.f + expf(-e)))")],
    "K-H2 chunks of 32 pixels": [(PY, "H2_PIXELS = K3_PIXELS", "H2_PIXELS = (32,)")],
    "K-H2 8 pixels in flight": [
        (H2_SRC, "int U = FM <= 2 ? 4 : 2;  // pixels whose loads are in flight together\n"
                 "  const int CV = C / VEC, GC = G * C, GF",
         "int U = FM <= 2 ? 8 : 2;  // pixels whose loads are in flight together\n"
         "  const int CV = C / VEC, GC = G * C, GF")],
    "K-H2 at most 85 registers": [
        (H2_SRC, "__launch_bounds__(kHeadThreads)\nsimam_head_kernel",
         "__launch_bounds__(kHeadThreads, 3)\nsimam_head_kernel")],
    "K-H1 taps with /": [(H1_SRC, "round_to<T>(div_rn_by(lg[k], den, rden))",
                          "round_to<T>(lg[k] / den)")],
    "K-H1 one pass a block": [(PY, "H1_PASSES = (8, 4, 2, 1)", "H1_PASSES = (1,)")],
    "K-H1 passes of 32 pixels": [(PY, "H1_PASS = 16 ", "H1_PASS = 32 ")],
    "K-H1 passes of 8 pixels": [(PY, "H1_PASS = 16 ", "H1_PASS = 8 ")],
    "K-C' at most 128 registers": [
        (K4_SRC, "  static constexpr bool kCopy = true;\n  static constexpr int kMinBlocks = 3;",
         "  static constexpr bool kCopy = true;\n  static constexpr int kMinBlocks = 2;")],
    "K-C' at most 64 registers": [
        (K4_SRC, "  static constexpr bool kCopy = true;\n  static constexpr int kMinBlocks = 3;",
         "  static constexpr bool kCopy = true;\n  static constexpr int kMinBlocks = 4;")],
    "K-C' strips of 4 columns": [(PY, "KC_PX, KC_WAVES = K4_PX, WAVES",
                                  "KC_PX, KC_WAVES = (4, 2, 1), WAVES")],
    "K-C' 2 waves": [(PY, "KC_PX, KC_WAVES = K4_PX, WAVES", "KC_PX, KC_WAVES = K4_PX, 2")],
    "K-C' strips of 4 columns, 2 waves": [(PY, "KC_PX, KC_WAVES = K4_PX, WAVES",
                                           "KC_PX, KC_WAVES = (4, 2, 1), 2")],
    "K-C' without dx (outputs wrong)": [
        (K4_SRC, "for (int cb = 0; cb < CV; cb += CVL) {",
         "for (int cb = 0; cb < (Dacc::kCopy ? 0 : CV); cb += CVL) {")],
    "K-C' without dp (outputs wrong)": [
        (K4_SRC, "for (int cv = cvl; cv < CV; cv += CVL) {",
         "for (int cv = cvl; cv < (Dacc::kCopy ? 0 : CV); cv += CVL) {")],
    "K-C' runs of 1 row": [
        (CK_PY, "vec, elem, 1, False, sms, copy=True)",
         "vec, elem, 1, False, sms, copy=True, tile=(1, 8))")],
    "K-C' runs of 16 rows": [
        (CK_PY, "vec, elem, 1, False, sms, copy=True)",
         "vec, elem, 1, False, sms, copy=True, tile=(16, 8))")],
    "K5 chunks of 64 pixels": [(PY, "K5_PIXELS = K3_PIXELS ", "K5_PIXELS = (64,) ")],
    "K5 chunks of 256 pixels": [(PY, "K5_PIXELS = K3_PIXELS ", "K5_PIXELS = (256,) ")],
    "K5 8 pixels in flight": [(K5_SRC, K5_U, K5_U.replace("FM <= 2 ? 4 : 2", "FM <= 2 ? 8 : 4"))],
    "K5 2 pixels in flight": [(K5_SRC, K5_U, K5_U.replace("FM <= 2 ? 4 : 2", "2"))],
    # every pixel's slots split over blockIdx.y at the flagship too (K3's as well)
    "K5 slots split at 64 threads": [
        (K5_SRC, "constexpr int kSlotThreads = 256;", "constexpr int kSlotThreads = 64;"),
        (PY, "SLOT_THREADS = 256 ", "SLOT_THREADS = 64 ")],
    "K5 gate with /": [
        (K5_SRC, "div_rn_by(xc * xc, den[i], w4[i]) + 0.5f", "xc * xc / den[i] + 0.5f"),
        (K5_SRC, "const float gv = rcp_rn(1.f + expf(-e));",
         "const float gv = 1.f / (1.f + expf(-e));")],
    "K5 dx without FMAs": [(K5_SRC, K5_DX, "dg = __fsub_rn(__fsub_rn(__fadd_rn(__fmul_rn(dg, gv), "
                            "__fmul_rn(__fmul_rn(2.f * w4[i], t), xc)), ca[i]), "
                            "__fmul_rn(cb[i], xc));")],
    "K5 plain stores": [(K5_SRC, K5_STORE, K5_STORE.replace("store_vec_cs", "store_vec"))],
    "K5 at most 80 registers": [
        (K5_SRC, "template <typename T, int VEC, bool GATE, int FM, bool SPLIT>\n"
                 "__global__ void head_bwd2_kernel",
         "template <typename T, int VEC, bool GATE, int FM, bool SPLIT>\n__global__ void "
         "__launch_bounds__(256, 3) head_bwd2_kernel")],
    "K5 at most 64 registers": [
        (K5_SRC, "template <typename T, int VEC, bool GATE, int FM, bool SPLIT>\n"
                 "__global__ void head_bwd2_kernel",
         "template <typename T, int VEC, bool GATE, int FM, bool SPLIT>\n__global__ void "
         "__launch_bounds__(256, 4) head_bwd2_kernel")],
    "K-H2 2 pixels in flight": [
        (H2_SRC, "int U = FM <= 2 ? 4 : 2;  // pixels whose loads are in flight together\n"
                 "  const int CV = C / VEC, GC = G * C, GF",
         "int U = 2;  // pixels whose loads are in flight together\n"
         "  const int CV = C / VEC, GC = G * C, GF")],
}

# planted faults, each of which the card tests and the smoke must catch
FAULTS = {
    "K5 A term dropped": [(K5_SRC, "ca[i] = (2.f * w4[i] / count) * A[bc];",
                           "ca[i] = 0.f * A[bc];")],
    "K5 B term x 0.9": [(K5_SRC, "cb[i] = (8.f * (w4[i] * w4[i]) / count_m1) * Bq[bc];",
                         "cb[i] = (8.f * (w4[i] * w4[i]) / count_m1) * Bq[bc] * 0.9f;")],
    "K5 last pixel of a ragged chunk unwritten": [
        (K5_SRC, K5_STORE, "      if (n == pc || u0 + u != n - 1)\n  " + K5_STORE)],
    "K-C tap 4 x 0.95": [
        (H1_SRC, "const float p = pr[s * 9 + k];",
         "const float p = pr[s * 9 + k] * (!BIAS && k == 4 ? 0.95f : 1.f);")],
    "K-C' dp lane 1 dropped from the butterfly": [
        (K4_SRC, "for (int k = 0; k < 9; ++k) dp[k] += __shfl_xor_sync(0xffffffffu, dp[k], off);",
         "for (int k = 0; k < 9; ++k) { const float o = __shfl_xor_sync(0xffffffffu, dp[k], off);"
         " dp[k] += (Dacc::kCopy && off == 1 && lane == 0) ? 0.f : o; }")],
    "K-C' ring slot one row off": [
        (K4_SRC, "const int sc = (y - y0 + 1) % 3;",
         "const int sc = (y - y0 + 1 + (Dacc::kCopy ? 1 : 0)) % 3;")],
}

CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from cswin_simam_unet_tpu_torch import _build
from cswin_simam_unet_tpu_torch.ops import carafe, carafe_head, carafe_kernels, simam_head
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
    out[f"K4 no gate {label}"] = device_ms(lambda: carafe_head.fused_head_bwd(
        x, enc, fb, dy, None, None, None, None, w, 4, gate=False))
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
    h1_args = (x, enc, randn(E, scale=0.1), 4)
    out[f"K-H1 {label}"] = device_ms(lambda: carafe_head.carafe_biased_moments(*h1_args))
    out[f"K-H1 no moments {label}"] = device_ms(
        lambda: carafe_head.carafe_biased_moments(*h1_args, gate=False))
    out[f"K-H2 {label}"] = device_ms(lambda: carafe_head.simam_head_flat(fb, mu, v, wt, G))
    out[f"K5 {label}"] = device_ms(lambda: simam_head.head_bwd2(fb, dy, mu, v, A, Bq, w, G))
    out[f"K5 no gate {label}"] = device_ms(
        lambda: simam_head.head_bwd2(fb, dy, None, None, None, None, w, G, gate=False))
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
        b1 = h1_args[2]
        got = carafe_head.carafe_biased_moments(x1, e1, b1, 4)[0]
        ref = carafe.carafe_flat(x1.float(), e1.float(), 4) + b1.float().repeat(G)
        out["K-H1 error"] = float((got.float() - ref).abs().max() / ref.abs().max())
        got = carafe_head.simam_head_flat(fb1, mu1, v1, wt, G)
        ref = carafe_head.head_reference(f1, torch.zeros(E, device=dev), wt.float(), G)
        out["K-H2 error"] = float((got.float() - ref).abs().max() / ref.abs().max())
        for gate in (True, False):
            got = simam_head.head_bwd2(fb1, dy1, mu1, v1, want[0], want[1], w, G, gate=gate)
            ref = carafe_head.head_bwd2_reference(f1, dy1.float(), mu1, v1, want[0],
                                                  want[1], w, G, gate=gate)
            out["K5 error" if gate else "K5 no gate error"] = max(
                float((a.float() - b).abs().max() / b.abs().max()) for a, b in zip(got, ref))
    del fb, dy, x, enc
    torch.cuda.empty_cache()
# cswinunet's head: 448^2, batch 2, float32, no SimAM
r = 112
x, enc = randn(2, r, r, E, dtype=torch.float32), randn(2, r, r, 9 * G, dtype=torch.float32)
b = randn(E, scale=0.1, dtype=torch.float32)
w = randn(E, F, scale=E ** -0.5, dtype=torch.float32)
fb = carafe_head.carafe_biased_moments(x, enc, b, 4, False)[0]
out["K-H1 448 f32 no gate"] = device_ms(lambda: carafe_head.carafe_biased_moments(
    x, enc, b, 4, False))
out["K-H2 448 f32 no gate"] = device_ms(lambda: carafe_head.simam_head_flat(
    fb, None, None, w, G, gate=False))
dy = randn(2, r, r, G * F, dtype=torch.float32)
out["K4 448 f32 no gate"] = device_ms(lambda: carafe_head.fused_head_bwd(
    x, enc, fb, dy, None, None, None, None, w, 4, gate=False))
mu, v = pooled_stats(fb.sum((1, 2)), (fb * fb).sum((1, 2)), r * r * G, G)
A, Bq, _ = carafe_head.head_bwd1(fb, dy, mu, v, w, G)
out["K4 448 f32"] = device_ms(
    lambda: carafe_head.fused_head_bwd(x, enc, fb, dy, mu, v, A, Bq, w, 4))
out["K5 448 f32"] = device_ms(lambda: simam_head.head_bwd2(fb, dy, mu, v, A, Bq, w, G))
out["K5 no gate 448 f32"] = device_ms(
    lambda: simam_head.head_bwd2(fb, dy, None, None, None, None, w, G, gate=False))
del x, enc, fb, dy
# K-C and K-C' at the decoder's three CARAFEs (upsample4, 3, 2: S 2, C 256,
# 128, 64 at img/32, img/16, img/8), summed; errors at 512^2, batch 1
for label, B, img, dtype in (("512", 8, 512, torch.bfloat16), ("2048", 1, 2048, torch.bfloat16),
                             ("448 f32", 2, 448, torch.float32)):
    fwd = bwd = 0.0
    for r, C in ((img // 32, 256), (img // 16, 128), (img // 8, 64)):
        x, enc = randn(B, r, r, C, dtype=dtype), randn(B, r, r, 36, dtype=dtype)
        d = randn(B, r, r, 4 * C, dtype=dtype)
        fwd += device_ms(lambda: carafe_kernels.carafe_flat(x, enc, 2))
        out[f"K-C' {label} at {r}^2"] = device_ms(
            lambda: carafe_kernels.carafe_flat_bwd(x, enc, d, 2))
        bwd += out[f"K-C' {label} at {r}^2"]
        if label == "512":
            x1, e1, d1 = x[:1], enc[:1], d[:1]
            ref = carafe.carafe_flat(x1.float(), e1.float(), 2)
            got = carafe_kernels.carafe_flat(x1, e1, 2)
            out["K-C error"] = max(out.get("K-C error", 0.0), float(
                (got.float() - ref).abs().max() / ref.abs().max()))
            got = carafe_kernels.carafe_flat_bwd(x1, e1, d1, 2)
            ref = carafe.carafe_bwd_reference(x1.float(), e1.float(), d1.float(), 2)
            out["K-C' error"] = max([out.get("K-C' error", 0.0)] + [
                float((a.float() - b).abs().max() / b.abs().max()) for a, b in zip(got, ref)])
        del x, enc, d
    out[f"K-C {label}"], out[f"K-C' {label}"] = fwd, bwd
print("RESULT " + json.dumps(out))
"""


def make_copy(name: str, patches, root: Path = ROOT) -> Path:
    """A copy of this package under ``root`` with ``patches`` applied."""
    root = root / name.replace(" ", "_").replace("/", "div").replace("(", "").replace(")", "")
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


def run_fault(name: str, patches, select: str, root: Path = ROOT) -> dict:
    """The card tests ``-k select`` and the smoke in a copy with fault
    ``name`` (``patches``)."""
    root = make_copy(name, patches, root)
    shutil.copytree(PKG.parent / "tests", root / "tests", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in ("chip_smoke.py", "pyproject.toml"):
        shutil.copy(PKG.parent / f, root / f)
    env = {**os.environ, "PYTHONPATH": ""}
    tests = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_port_cuda.py", "-q",
                            "-p", "no:cacheprovider", "--noconftest", "-k", select],
                           cwd=root, capture_output=True, text=True, timeout=900, env=env)
    smoke = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root, capture_output=True,
                           text=True, timeout=1200, env=env)
    lines = tests.stdout.splitlines()
    return {"fault": name, "tests": ([l for l in lines if " passed" in l or " failed" in l]
                                     or ["no summary"])[-1],
            "failed": [l.split()[1] for l in lines if l.startswith("FAILED")],
            "smoke_rc": smoke.returncode,
            "smoke_error": ([l for l in smoke.stderr.splitlines() if "Error" in l] or [""])[-1]}


def main(variants=VARIANTS, faults=FAULTS, child=CHILD, root: Path = ROOT,
         select: str = "carafe or tiny_model or head_bwd2 or head_bwd_kernels_wide "
                       "or simam_head_function or entry_points") -> int:
    """The command line: time ``variants`` (or plant ``faults`` and run the
    card tests ``-k select`` and the smoke), each copy under ``root``, each
    timed by the script ``child``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", help="variant names to run (default: all)")
    ap.add_argument("--baseline", type=Path,
                    help="a checkout whose package runs as the variant 'baseline'")
    ap.add_argument("--faults", action="store_true",
                    help="plant the faults instead; fails unless every one is caught")
    args = ap.parse_args()
    if args.faults:
        missed = 0
        for name in args.only or list(faults):
            out = run_fault(name, faults[name], select, root)
            missed += not out["failed"] or out["smoke_rc"] == 0
            print(json.dumps(out), flush=True)
        return 1 if missed else 0
    names = args.only or list(variants) + (["baseline"] if args.baseline else [])
    failed = 0
    for name in names:  # one after the other: each builds and times alone on the card
        if name == "baseline":
            copy = args.baseline.resolve()
        else:
            copy = make_copy(name, variants[name], root)
        run = subprocess.run([sys.executable, "-c", child, str(copy)], capture_output=True,
                             text=True, timeout=900, env={**os.environ, "PYTHONPATH": ""})
        lines = [l for l in run.stdout.splitlines() if l.startswith("RESULT ")]
        if run.returncode or not lines:
            failed += 1
            print(json.dumps({"variant": name, "failed": run.stderr[-3000:]}), flush=True)
            continue
        print(json.dumps({"variant": name, **json.loads(lines[0][7:])}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
