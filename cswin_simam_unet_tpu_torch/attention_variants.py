"""The v1 window-attention kernels, K-V1 and K-V1', against variants of
themselves on the card, and the attention kernels that share their bodies
(K-A, K-A', the tiled K-A / K-A', the flash family) against another tree.

    python -m cswin_simam_unet_tpu_torch.attention_variants [--only NAME ...]
        [--baseline DIR] [--faults]

Each variant is a copy of this package under ``build/attention_variants/``
with one change to a kernel's source, built there and timed in a process of
its own, behind a spin kernel (device time, wrapper glue included): K-V1 and
K-V1' summed over the 50 attention branches of ``cswin_simam_512`` at batch
8 in bf16, as (G, Np, D) groups, beside SDPA's forward (boolean key mask)
and backward on the same groups; K-A and K-A' (rate 0) over the same
branches; the tiled K-A / K-A' (window mode) and the flash forward, dq and
dk/dv (flash mode) over the attention branches of ``cswin_simam_2048`` at
batch 1 in bf16; and the largest error of K-V1 and of each output of K-V1'
over its own max|plain| at the flagship's groups (batch 1).  The variants
are the designs that were weighed: K-V1' on the tiled dq and dk/dv bodies
(two launches, dq sweeping the keys twice) against the whole-window body,
and K-V1 on the forward's whole-window form (K and V held whole, two
sweeps) against the online one.  ``--baseline DIR`` adds the variant
``baseline``, the package of the checkout at DIR, so that ``--only baseline
"as built" "as built" baseline`` compares two trees in turns.  ``--faults``
plants each of FAULTS in a copy and runs the v1 card tests (``-k
window_attention``) and ``chip_smoke.py`` there, which must fail.  Needs a
CUDA device; prints one JSON line per variant or fault.
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import head_bwd_variants

ROOT = Path(__file__).resolve().parent.parent / "build" / "attention_variants"
V1_SRC = "csrc/window_attention.cu"

# name -> [(file in the package, text, replacement)]
VARIANTS = {
    "as built": [],
    "K-V1' on the tiled dq and dk/dv bodies": [
        (V1_SRC, "  if (!v1_whole(D, a.Np)) {  // the tiled bodies",
         "  if (true) {  // the tiled bodies")],
    # parts of the whole-window K-V1' removed, to see where its time goes
    "K-V1' without phase A (outputs wrong)": [
        (V1_SRC, "    for (int j0 = 0; j0 < nk; j0 += 16) {\n      float s[2][4]",
         "    for (int j0 = 0; j0 < 0; j0 += 16) {\n      float s[2][4]")],
    "K-V1' without the ds^T stores (outputs wrong)": [
        (V1_SRC, "      dst[0] = da[0];\n      dst[4 * LDS] = da[1];\n      dst[4] = da[2];\n"
                 "      dst[4 * LDS + 4] = da[3];\n", "")],
    "K-V1' without phase C (outputs wrong)": [
        (V1_SRC, "  for (int j0 = 0; j0 < nk; j0 += 16) {\n    uint32_t da[4];",
         "  for (int j0 = 0; j0 < 0; j0 += 16) {\n    uint32_t da[4];")],
    "K-V1' loads only (outputs wrong)": [
        (V1_SRC, "    for (int j0 = 0; j0 < nk; j0 += 16) {\n      float s[2][4]",
         "    for (int j0 = 0; j0 < 0; j0 += 16) {\n      float s[2][4]"),
        (V1_SRC, "  if (r0 < nk) {", "  if (r0 < 0) {"),
        (V1_SRC, "  for (int j0 = 0; j0 < nk; j0 += 16) {\n    uint32_t da[4];",
         "  for (int j0 = 0; j0 < 0; j0 += 16) {\n    uint32_t da[4];")],
    "K-V1 whole-window forward": [
        (V1_SRC, "attention_fwd<D, false, false, true>", "attention_fwd<D, false, true, true>"),
        (V1_SRC, "  constexpr size_t smem = mma::fwd_smem<D>(2);\n  static std::atomic<int> "
                 "opted[kMaxDevices];\n  const cudaError_t e = opt_in_smem(v1_fwd_mma_kernel",
         "  const size_t smem = mma::fwd_smem<D>((a.nvalid + mma::kTile - 1) / mma::kTile);\n"
         "  static std::atomic<int> opted[kMaxDevices];\n"
         "  const cudaError_t e = opt_in_smem(v1_fwd_mma_kernel")],
}

# planted faults in the whole-window K-V1', each of which the card tests and
# the smoke must catch
FAULTS = {
    "K-V1' dq x 0.9": [
        (V1_SRC, "__floats2bfloat162_rn(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale)",
         "__floats2bfloat162_rn(acc[n][2 * r] * a.scale * 0.9f, "
         "acc[n][2 * r + 1] * a.scale * 0.9f)")],
    "K-V1' P^T dO x 0.95 in dv": [
        (V1_SRC, "__floats2bfloat162_rn(av[n][2 * r], av[n][2 * r + 1])",
         "__floats2bfloat162_rn(av[n][2 * r] * 0.95f, av[n][2 * r + 1] * 0.95f)")],
    "K-V1' a masked key left unmasked": [
        (V1_SRC, "const bool masked[2] = {r0 + g >= a.nvalid, r0 + g + 8 >= a.nvalid};",
         "const bool masked[2] = {r0 + g >= a.Np, r0 + g + 8 >= a.Np};")],
}

CHILD = r"""
import json, sys, torch
import torch.nn.functional as F
sys.path.insert(0, sys.argv[1])
from cswin_simam_unet_tpu_torch.configs import build_model
from cswin_simam_unet_tpu_torch.models.layers import LePEAttention
from cswin_simam_unet_tpu_torch.ops import attention, flash_attention as fa
from cswin_simam_unet_tpu_torch.ops import stripe_attention as sa, window_attention as wa

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


def geometries(name):
    model = build_model(name, device="cpu")
    geoms = {}
    for mod in model.modules():
        if isinstance(mod, LePEAttention):
            key = (mod.resolution, mod.get_v.weight.shape[0], mod.num_heads, mod.hsp, mod.wsp)
            geoms[key] = geoms.get(key, 0) + 1
    return geoms


def rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


out = {k: 0.0 for k in ("K-V1", "K-V1'", "SDPA fwd", "SDPA bwd", "K-A", "K-A'")}
out.update({"K-V1 error": 0.0, "K-V1' dq error": 0.0, "K-V1' dk error": 0.0,
            "K-V1' dv error": 0.0})
for (reso, Cb, heads, hsp, wsp), count in sorted(geometries("cswin_simam_512").items()):
    N, D = hsp * wsp, Cb // heads
    Np, G = -(-N // wa.PAD) * wa.PAD, 8 * (reso // hsp) * (reso // wsp) * heads
    scale = D ** -0.5
    q, k, v, do = (randn(G, Np, D, scale=0.5) for _ in range(4))
    _, lse = wa.kernel_fwd(q, k, v, scale, N)
    out["K-V1"] += count * device_ms(lambda: wa.kernel_fwd(q, k, v, scale, N))
    bwd = device_ms(lambda: wa.kernel_bwd(q, k, v, lse, do, scale, N))
    out["K-V1'"] += count * bwd
    out[f"K-V1' per branch ({G}, {Np}, {D})"] = bwd
    mask = (torch.arange(Np, device=dev) < N).view(1, 1, 1, Np)
    qg, kg, vg = (t[:, None].detach().requires_grad_() for t in (q, k, v))
    out["SDPA fwd"] += count * device_ms(lambda: F.scaled_dot_product_attention(
        q[:, None], k[:, None], v[:, None], attn_mask=mask, scale=scale))
    sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
    out["SDPA bwd"] += count * device_ms(lambda: torch.autograd.grad(
        sdpa, (qg, kg, vg), do[:, None], retain_graph=True))
    g1 = G // 8  # errors at batch 1
    q1, k1, v1, do1 = (t[:g1] for t in (q, k, v, do))
    o1, lse1 = wa.kernel_fwd(q1, k1, v1, scale, N)
    f = [t.float() for t in (q1, k1, v1)]
    out["K-V1 error"] = max(out["K-V1 error"],
                            rel(o1, wa.window_attention_reference(*f, scale, N)))
    got = wa.kernel_bwd(q1, k1, v1, lse1, do1, scale, N)
    want = wa.window_attention_bwd_reference(*f, do1.float(), scale, N)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        out[f"K-V1' {name} error"] = max(out[f"K-V1' {name} error"], rel(a, b))
    # K-A and K-A' on the same branches, as (B, L, C) tokens with the LePE
    kw = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads)
    qt, kt, vt, gt = (randn(8, reso * reso, Cb, scale=0.5) for _ in range(4))
    w = randn(3, 3, 1, Cb, scale=1 / 3)
    out["K-A"] += count * device_ms(lambda: sa.stripe_attention(qt, kt, vt, w, **kw))
    _, lt = sa.attention_fwd(qt, kt, vt, w, **kw, with_lse=True)
    out["K-A'"] += count * device_ms(lambda: sa.attention_bwd(qt, kt, vt, w, gt, **kw, lse=lt))
    del q, k, v, do, lse, qg, kg, vg, sdpa, qt, kt, vt, gt
    torch.cuda.empty_cache()
for key in ("tiled K-A", "tiled K-A' dq", "tiled K-A' dkv", "flash fwd", "flash dq",
            "flash dkv"):
    out[key] = 0.0
for (reso, Cb, heads, hsp, wsp), count in sorted(geometries("cswin_simam_2048").items()):
    N = hsp * wsp
    if sa.whole_window(N, Cb // heads):  # the whole-window K-A / K-A'
        continue
    kw = dict(H=reso, W=reso, hsp=hsp, wsp=wsp, num_heads=heads)
    tiled = N <= fa.FLASH_MIN_TOKENS
    mode, pre = ("window", "tiled K-A") if tiled else ("flash", "flash")
    q, k, v, g = (randn(1, reso * reso, Cb, scale=0.5) for _ in range(4))
    lepe = randn(3, 3, 1, Cb, scale=1 / 3) if tiled else None
    o, lse = fa.kernel_fwd(q, k, v, lepe, **kw, mode=mode)
    delta = None if tiled else fa.flash_delta(o, g, heads).reshape(lse.shape)
    _, dl = fa.kernel_dq(q, k, v, lse, g, **kw, delta=delta, mode=mode)
    out[pre if tiled else "flash fwd"] += count * device_ms(
        lambda: fa.kernel_fwd(q, k, v, lepe, **kw, mode=mode))
    out[("tiled K-A' dq" if tiled else "flash dq")] += count * device_ms(
        lambda: fa.kernel_dq(q, k, v, lse, g, **kw, delta=delta, mode=mode))
    out[("tiled K-A' dkv" if tiled else "flash dkv")] += count * device_ms(
        lambda: fa.kernel_dkv(q, k, v, lepe, lse, dl, g, **kw, mode=mode))
    del q, k, v, g, o, lse, dl
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def main() -> int:
    return head_bwd_variants.main(VARIANTS, FAULTS, CHILD, ROOT, "window_attention")


if __name__ == "__main__":
    sys.exit(main())
