"""K-LN' (the LayerNorm backward) and K-LN (its forward) against variants of
themselves on the card.

    python -m cswin_simam_unet_tpu_torch.layernorm_variants [--only NAME ...]
        [--baseline DIR] [--faults]

Each variant is a copy of this package under ``build/layernorm_variants/``
with one change to ``csrc/layernorm.cu`` (or the wrapper's mirror of its
launch shape), built there and timed in a process of its own, behind a spin
kernel (device time, the wrapper's allocations and any torch glue
included): ``layernorm.kernel_bwd`` and ``kernel_fwd`` at the flagship's
four LayerNorm shapes (``cswin_simam_512``, batch 8, bf16) and at
``cswinunet``'s four (batch 2, float32), beside ``F.layer_norm``'s forward
and backward on the same inputs; their sums over the four flagship shapes
and over the flagship's 58 LayerNorms of a training step (6, 9, 37 and 6
at 64, 128, 256 and 512 channels); and the largest error of each output
over its own max|plain| at the flagship's shapes.  The variants are the
design choices of K-LN': rows in flight, blocks an SM, the partials' sum
launched early or not, streaming stores, and, with outputs wrong, the rows'
pass alone without the sum.  ``--baseline DIR`` adds the variant
``baseline``, the package of the checkout at DIR (another commit's tree),
so that ``--only baseline "as built" "as built" baseline`` compares two
trees in turns.  ``--faults`` plants each of FAULTS in a copy and runs the
LayerNorm card tests (``-k layernorm``) and ``chip_smoke.py`` there, which
must fail.  Needs a CUDA device; prints one JSON line per variant or fault.
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import head_bwd_variants

ROOT = Path(__file__).resolve().parent.parent / "build" / "layernorm_variants"
LN_SRC, LN_PY = "csrc/layernorm.cu", "ops/layernorm.py"

LN_STORE = "        store_vec<T, VEC>(dx + r * C + v * VEC, o);"
LN_DX = "o[e] = rstd[i] * (de[e] * gv[k] - m1[i] - xh * m2[i]);"
LN_SUM = "s += __ldcg(part + p * n + j);"


def _blocks_per_sm(n: int):
    return [(LN_SRC, "constexpr int kLnBwdBlocksPerSm = 2;",
             f"constexpr int kLnBwdBlocksPerSm = {n};"),
            (LN_PY, "BWD_BLOCKS_PER_SM = 2 ", f"BWD_BLOCKS_PER_SM = {n} ")]


def _loads(n: int):
    return [(LN_SRC, "constexpr int kLnBwdLoads = 2;", f"constexpr int kLnBwdLoads = {n};"),
            (LN_PY, "BWD_LOADS = 2 ", f"BWD_LOADS = {n} ")]


LN_LOOP = """      b.load(x, dy, s0 + p0 + step, stripe, r1, C, nv, l);
      a.rows(dx, gv, sg, sb, s0 + p0, stripe, r1, C, nv, l, eps);
      if (r0 + p0 + step >= r1) break;
      a.load(x, dy, s0 + p0 + 2 * step, stripe, r1, C, nv, l);
      b.rows(dx, gv, sg, sb, s0 + p0 + step, stripe, r1, C, nv, l, eps);"""
LN_LOOP_PLAIN = """      a.rows(dx, gv, sg, sb, s0 + p0, stripe, r1, C, nv, l, eps);
      if (r0 + p0 + step >= r1) break;
      b.load(x, dy, s0 + p0 + step, stripe, r1, C, nv, l);
      b.rows(dx, gv, sg, sb, s0 + p0 + step, stripe, r1, C, nv, l, eps);
      a.load(x, dy, s0 + p0 + 2 * step, stripe, r1, C, nv, l);"""

# name -> [(file in the package, text, replacement)]
VARIANTS = {
    "as built": [],
    "K-LN' 1 load a pass": _loads(1),
    "K-LN' without the prefetch": [(LN_SRC, LN_LOOP, LN_LOOP_PLAIN)],
    "K-LN' one block an SM": _blocks_per_sm(1),
    "K-LN' three blocks an SM": _blocks_per_sm(3),
    "K-LN' three blocks an SM, 1 load in flight": _blocks_per_sm(3) + _loads(1),
    "K-LN' four loads a pass, one pass held": _loads(4),
    "K-LN' sum launched after the rows": [
        (LN_SRC, "constexpr bool kLnSumEarly = true;", "constexpr bool kLnSumEarly = false;")],
    "K-LN' streaming dx stores": [(LN_SRC, LN_STORE, LN_STORE.replace("store_vec", "store_vec_cs"))],
    "K-LN' rows without the sum (outputs wrong)": [
        (LN_SRC, "  cudaError_t e = cudaGetLastError();\n  if (e != cudaSuccess) return e;\n"
                 "  const int n = 2 * a.C;",
         "  cudaError_t e = cudaGetLastError();\n  if (true) return e;\n"
         "  const int n = 2 * a.C;")],
}

# planted faults, each of which the card tests and the smoke must catch
FAULTS = {
    "K-LN' m2 term dropped": [(LN_SRC, LN_DX, LN_DX.replace(" - xh * m2[i]", ""))],
    "K-LN' last row of the last (ragged) block unwritten": [
        (LN_SRC, LN_STORE, "        if (blockIdx.x + 1 < gridDim.x || r != r1 - 1)\n  " + LN_STORE)],
    "K-LN' one block's dg partial left out of the sum": [
        (LN_SRC, LN_SUM, "s += p == 1 && j < n / 2 ? 0.f : __ldcg(part + p * n + j);")],
}

CHILD = r"""
import json, sys, torch
import torch.nn.functional as F
sys.path.insert(0, sys.argv[1])
from cswin_simam_unet_tpu_torch.ops import layernorm

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)


def randn(*shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)


def device_ms(fn, iters=20):
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


PER_STEP = {64: 6, 128: 9, 256: 37, 512: 6}  # the flagship's LayerNorms by channels
out = {}
for label, B, r, dtype in (("512", 8, 128, torch.bfloat16), ("448 f32", 2, 112, torch.float32)):
    for key in ("K-LN'", "K-LN", "F.layer_norm bwd", "F.layer_norm fwd"):
        out[f"{key} {label}"] = 0.0
        out[f"{key} {label} per step"] = 0.0
    for s in range(4):
        M, C = B * (r >> s) ** 2, 64 << s
        x, dy = randn(M, C, scale=2.0, dtype=dtype), randn(M, C, dtype=dtype)
        g, b = randn(C, scale=0.3) + 1.0, randn(C, scale=0.1)
        xg, gg, bg = (t.detach().to(dtype).requires_grad_() for t in (x, g, b))
        lib = F.layer_norm(xg, (C,), gg, bg, 1e-5)
        times = {
            "K-LN'": device_ms(lambda: layernorm.kernel_bwd(x, g, dy)),
            "K-LN": device_ms(lambda: layernorm.kernel_fwd(x, g, b)),
            "F.layer_norm bwd": device_ms(lambda: torch.autograd.grad(
                lib, (xg, gg, bg), dy, retain_graph=True)),
            "F.layer_norm fwd": device_ms(lambda: F.layer_norm(x, (C,), gg.detach(),
                                                               bg.detach(), 1e-5)),
        }
        for key, t in times.items():
            out[f"{key} ({M}, {C})"] = t
            out[f"{key} {label}"] += t
            out[f"{key} {label} per step"] += PER_STEP[C] * t
        if label == "512":  # each output's error over its own max|plain|
            got = layernorm.kernel_bwd(x, g, dy)
            want = layernorm.ln_bwd_reference(x.float(), g, dy.float())
            for name, a, w in zip(("dx", "dg", "db"), got, want):
                err = float((a.float() - w).abs().max() / w.abs().max())
                out[f"K-LN' {name} error"] = max(out.get(f"K-LN' {name} error", 0.0), err)
        del x, dy, xg, lib
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def main() -> int:
    return head_bwd_variants.main(VARIANTS, FAULTS, CHILD, ROOT, "layernorm")


if __name__ == "__main__":
    sys.exit(main())
