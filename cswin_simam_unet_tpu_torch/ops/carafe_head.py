"""Kernels K-H1, K-H2, K3 and K4: the fused final head, forward and backward.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_carafe_head.py::
carafe_simam_head`` and its custom VJP: CARAFE 4x reassembly of the low-res
map, the out-conv bias added in the compute dtype, SimAM over the flat map
with statistics pooled per real channel, and the grouped 1x1 head dot.

Forward:
* K-H1 (``csrc/carafe_head_fwd.cu``, ``csu_carafe_head_fwd``): reassembly +
  bias, writing the flat map fb and per-block sums of it and of its square
  per real channel;
* between them, plain torch pools the sums into (mu, v) per real channel
  (as the JAX package does outside its kernel);
* K-H2 (``csrc/simam_head.cu``, ``csu_simam_head_fwd``): gate + head dot.

Backward (SimAM on):
* K3 (``csrc/simam_head.cu``, ``csu_head_bwd1``): per-block partials (a
  chunk of pixels a block) of the SimAM VJP reductions A, B and of dW; plain
  torch sums them and pools A and B per real channel
  (``pallas_simam_head.py:286-291``);
* K4 (``csrc/carafe_head_bwd.cu``, ``csu_carafe_head_bwd``): the head's
  elementwise VJP recomputed from fb, row by row down a block's run, and fed
  straight into the CARAFE backward -> dx, denc and per-block bias-gradient
  partials.

:func:`h1_geometry`, :func:`h2_geometry`, :func:`k4_geometry` and
:func:`k3_geometry` pick the four kernels' blocks (mirroring the C side's
shared-memory formulas and block decodes).  The decoder's CARAFE kernels
run on two of these bodies (``ops/carafe_kernels.py``): K-C on K-H1's
without the bias and the moments, K-C' on K4's with dacc loaded
(``k4_geometry(..., copy=True)``).

Backward without SimAM (``gate=False``):
* K3 without the gate (``csu_head_bwd1_nogate``, for
  ``pallas_simam_head.py::_bwd1_nogate_kernel``): per-block partials of
  dW = sum fb * dy;
* K4 without the gate (``csu_carafe_head_bwd_nogate``, the ``gate=False``
  branch of ``pallas_carafe_head.py::_fused_bwd_kernel``): dacc = dy W^T
  into the CARAFE backward.

:func:`carafe_simam_head` is a ``torch.autograd.Function``; CUDA tensors go
to the kernels, CPU tensors to the plain versions (:func:`reference`,
:func:`head_bwd1_reference`, :func:`fused_head_bwd_reference`, which
takes its dacc from :func:`head_bwd2_reference`, the plain version of the
standalone head's K5).
"""

from __future__ import annotations

import torch

from .. import _build
from . import carafe
from .simam import LAMBDA, pooled_stats
from .windows import pixel_unshuffle

MOMENTS_KERNEL = "csu_carafe_head_fwd"
HEAD_KERNEL = "csu_simam_head_fwd"
BWD1_KERNEL = "csu_head_bwd1"
FUSED_BWD_KERNEL = "csu_carafe_head_bwd"
BWD1_NOGATE_KERNEL = "csu_head_bwd1_nogate"
FUSED_BWD_NOGATE_KERNEL = "csu_carafe_head_bwd_nogate"
MAX_CLASSES = 8

# Launch geometry of K-H1, K-H2, K3 and K4 (csrc/carafe_head_fwd.cu,
# csrc/simam_head.cu, csrc/carafe_head_bwd.cu).
H100_SMS = 132
WAVES = 4                      # the grid fills the card's SMs at least this many times
SMEM_LIMIT = 227 * 1024        # shared memory one block may use (common.cuh kMaxSmem)
K4_SMEM_BUDGET = 113 * 1024    # K4 picks the widest strip that keeps two blocks an SM
K4_PX = (8, 4, 2, 1)           # own columns of a K4 block, a warp each
K4_ROWS = (32, 16, 8, 4, 2, 1)  # rows of a K4 block's run, the longest that fills the card
KC_PX, KC_WAVES = K4_PX, WAVES  # the same for K-C' (K4's body, copy=True)
K3_PIXELS = (1024, 512, 256, 128, 64, 32, 16)  # pixels of a K3 block, the same way
H2_PIXELS = K3_PIXELS          # pixels of a K-H2 block, the same way
K5_PIXELS = K3_PIXELS          # pixels of a K5 block (ops/simam_head.py), the same way
SLOT_THREADS = 256             # (g, channel vector) slots of a K3 or K5 block at most
MAX_GRID_Y = 65535             # blocks along blockIdx.y at most (the slices above)
H2_THREADS = 256               # threads of a K-H2 block at most (simam_head.cu)
H1_THREADS = 256               # threads of a K-H1 block at most (carafe_head_fwd.cu)
H1_SMEM = 48 * 1024            # shared memory of a K-H1 block at most
H1_PASS = 16                   # pixels of one K-H1 pass at most (128 threads in bf16)
H1_PASSES = (8, 4, 2, 1)       # passes of a K-H1 block, the most that fills the card


def check_carafe_args(x: torch.Tensor, enc: torch.Tensor, up_factor: int,
                      ksize: int) -> None:
    if ksize != 3:
        raise ValueError(f"the CARAFE kernels take ksize 3, got {ksize}")
    B, H, W, C = x.shape
    if enc.shape != (B, H, W, 9 * up_factor * up_factor):
        raise ValueError(f"enc must be {(B, H, W, 9 * up_factor ** 2)}, "
                         f"got {tuple(enc.shape)}")
    _build.check_cuda(x, enc)


def threads_for(C: int, S: int, vec: int) -> int:
    """One thread per (sub-pixel, channel vector) of a pixel: the most that
    K4 and K-C' take (S^2*C/vec <= 1024)."""
    threads = S * S * (C // vec)
    if threads > 1024:
        raise ValueError(f"S^2*C/{vec} = {threads} threads exceed one block")
    return threads


def class_bound(F: int) -> int:
    """The compile-time class bound the kernels take for F classes."""
    return next(fm for fm in (1, 2, 4, 8) if F <= fm)


def k4_smem_bytes(C: int, S: int, vec: int, elem: int, px: int, F: int, gate: bool,
                  copy: bool = False) -> int:
    """Shared memory of one K4 block (csrc/carafe_head_bwd.cu::head_bwd_smem):
    the 3-row ring of dacc and p, the channel constants, W, and the db sums
    when a thread stages several vector slots; with ``copy`` (K-C', the
    policy CopyDacc) the ring and x of its rows."""
    def align16(n):
        return (n + 15) & ~15
    S2 = S * S
    SC, PW, NT = S2 * C, px + 2, 32 * px
    nvec = SC // vec
    single = nvec <= NT
    ring = align16(3 * PW * (SC + 9 * S2) * elem)
    if copy:
        return ring + align16(3 * PW * C * elem)
    scratch = (NT // nvec) * SC * 4 if single else 0
    return (max(ring, scratch) + (16 * C if gate else 0) + align16(4 * class_bound(F) * C)
            + (0 if single else 4 * SC))


def k4_geometry(B: int, H: int, W: int, C: int, S: int, vec: int, elem: int, F: int,
                gate: bool, sms: int = H100_SMS, tile: tuple[int, int] | None = None,
                copy: bool = False) -> dict:
    """K4's launch: a block owns ``px`` columns (a warp each, 32*px threads)
    and a run of ``rows`` rows of one image.  px is the widest (up to W)
    whose shared memory keeps two blocks an SM; rows the longest run that
    still gives WAVES x ``sms`` blocks (1 where none does).  ``tile`` =
    (rows, px) overrides both; ``copy`` sizes the block for K-C' (F and
    gate unused).  Raises where a block cannot fit."""
    threads_for(C, S, vec)
    if tile is not None:
        rows, px = tile
        if not (1 <= rows and 1 <= px <= K4_PX[0]):
            raise ValueError(f"K4 tile {tile}: rows >= 1 and 1 <= px <= {K4_PX[0]}")
    else:
        px = next(p for p in (KC_PX if copy else K4_PX) if p == 1 or (
            p <= W and k4_smem_bytes(C, S, vec, elem, p, F, gate, copy) <= K4_SMEM_BUDGET))
    smem = k4_smem_bytes(C, S, vec, elem, px, F, gate, copy)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a K4 block of C={C}, S={S} takes {smem} bytes of shared memory")
    strips = -(-W // px)
    if tile is None:
        waves = KC_WAVES if copy else WAVES
        rows = next(r for r in K4_ROWS if r == 1 or B * -(-H // r) * strips >= waves * sms)
    runs = -(-H // rows)
    return dict(px=px, rows=rows, strips=strips, runs=runs, blocks=B * runs * strips,
                threads=32 * px, smem=smem)


def k4_block_pixels(geom: dict, H: int, W: int, block: int):
    """(b, y0, y1, x0, x1): the image and own pixel rectangle of K4 block
    ``block``, decoded as the kernel decodes blockIdx.x."""
    strip, rest = block % geom["strips"], block // geom["strips"]
    run, b = rest % geom["runs"], rest // geom["runs"]
    y0, x0 = run * geom["rows"], strip * geom["px"]
    return b, y0, min(H, y0 + geom["rows"]), x0, min(W, x0 + geom["px"])


def k3_geometry(B: int, H: int, W: int, sms: int = H100_SMS,
                sizes: tuple[int, ...] = K3_PIXELS) -> dict:
    """K3's launch: a block owns ``pixels`` consecutive pixels of one image,
    the most of ``sizes`` that still gives WAVES x ``sms`` blocks (the
    fewest where none does).  Block ``i`` is chunk ``i % chunks`` of image
    ``i // chunks``."""
    pc = next(p for p in sizes if p == sizes[-1] or B * -(-(H * W) // p) >= WAVES * sms)
    chunks = -(-(H * W) // pc)
    return dict(pixels=pc, chunks=chunks, blocks=B * chunks)


def slot_split(slots: int) -> dict:
    """The threads of a K3 or K5 block, one a (g, channel vector) slot of a
    pixel: all ``slots`` where they fit SLOT_THREADS, else ``splits`` even
    slices of ``threads`` over blockIdx.y, the last one possibly short
    (csrc/simam_head.cu::slot_split).  Slot ``y*threads + t`` (those below
    ``slots``) is lane (g, c) = divmod(slot, C/vec), c in vectors."""
    splits = -(-slots // SLOT_THREADS)
    if splits > MAX_GRID_Y:
        raise ValueError(f"{slots} slots a pixel take {splits} slices, over the grid's "
                         f"{MAX_GRID_Y}")
    return dict(threads=-(-slots // splits), splits=splits)


def k5_geometry(B: int, H: int, W: int, C: int, G: int, vec: int,
                sms: int = H100_SMS) -> dict:
    """K5's launch: chunks of pixels as :func:`k3_geometry` picks them from
    K5_PIXELS, and the G*C/vec slots of a pixel by :func:`slot_split`, as
    K3's are.  The db partials are row ``i`` of (blocks, G*C) for block
    ``i``, whatever its slice."""
    return dict(k3_geometry(B, H, W, sms, K5_PIXELS), **slot_split(G * (C // vec)))


def h2_geometry(B: int, H: int, W: int, C: int, G: int, vec: int,
                sms: int = H100_SMS) -> dict:
    """K-H2's launch: K3's chunks of pixels (from H2_PIXELS), and groups of
    ``lanes`` threads, the largest power of two up to min(32, C/vec,
    H2_THREADS/G), one a (pixel, g); ``one`` where each lane holds exactly
    one channel vector (its constants in registers).  A block holds
    ``groups`` of the G groups: all of them where they fit H2_THREADS, else
    the largest divisor of G that does, the G/groups slices over blockIdx.y
    (``group_splits``; csrc/simam_head.cu::head_groups)."""
    cv = C // vec
    lanes = 1
    while lanes * 2 <= min(32, cv, H2_THREADS // G):
        lanes *= 2
    groups = G if G * lanes <= H2_THREADS else next(
        d for d in range(H2_THREADS // lanes, 0, -1) if G % d == 0)
    if G // groups > MAX_GRID_Y:
        raise ValueError(f"K-H2: G = {G} groups take {G // groups} slices of {groups}, "
                         f"over the grid's {MAX_GRID_Y}")
    return dict(k3_geometry(B, H, W, sms, H2_PIXELS), lanes=lanes, groups=groups,
                group_splits=G // groups, threads=groups * lanes, one=vec > 1 and cv == lanes)


def h1_smem_bytes(C: int, S: int, pass_pixels: int, stats: bool = True) -> int:
    """Shared memory of one K-H1 block (csrc/carafe_head_fwd.cu::h1_smem):
    two pass buffers of 9*S^2 + 1 floats a pixel, which the block's moment
    sums (2 x pass_pixels x C floats, with ``stats``) reuse."""
    ring = 2 * pass_pixels * (9 * S * S + 1)
    return 4 * (max(ring, 2 * pass_pixels * C) if stats else ring)


def h1_slice(cv: int, pass_pixels: int) -> int:
    """The channel vectors of a pixel that one K-H1 block covers: all ``cv``
    where a pass fits H1_THREADS, else even slices of at most H1_THREADS,
    one a blockIdx.y (csrc/carafe_head_fwd.cu::h1_slice)."""
    if pass_pixels * cv <= H1_THREADS:
        return cv
    return -(-cv // -(-cv // H1_THREADS))


def h1_geometry(B: int, H: int, W: int, C: int, S: int, vec: int,
                sms: int = H100_SMS, stats: bool = True) -> dict:
    """K-H1's launch: a thread owns a (pixel, channel vector) of a pass of
    ``pass_pixels`` pixels (up to H1_PASS, H1_THREADS threads and the shared
    memory's H1_SMEM); a block owns ``pixels`` = passes x pass_pixels
    consecutive pixels of one image, the most passes of H1_PASSES that still
    give WAVES x ``sms`` blocks.  Block ``i`` is chunk ``i % chunks`` of
    image ``i // chunks``; its moment sums (``stats``) are row ``i`` of
    (blocks, C).  Without ``stats`` (K-C, K-H1 without the gate) a pixel of
    more than H1_THREADS channel vectors takes one pixel a pass and its
    vectors in ``slices`` of ``slice`` over blockIdx.y.  Raises where a
    block cannot hold one pixel."""
    cv = C // vec
    pp = min(H1_PASS, H1_THREADS // cv) or (0 if stats else 1)
    while pp > 0 and h1_smem_bytes(C, S, pp, stats) > H1_SMEM:
        pp -= 1
    if pp < 1:
        raise ValueError(f"a K-H1 block cannot hold a pixel of C={C}, S={S} "
                         f"(C/{vec} > {H1_THREADS} threads with the moments, or 9*S^2 taps "
                         f"over shared memory)")
    sl = h1_slice(cv, pp)
    passes = next(n for n in H1_PASSES if n == H1_PASSES[-1]
                  or B * -(-(H * W) // (n * pp)) >= WAVES * sms)
    chunks = -(-(H * W) // (passes * pp))
    return dict(pass_pixels=pp, passes=passes, pixels=passes * pp, threads=pp * sl,
                slice=sl, slices=-(-cv // sl), chunks=chunks, blocks=B * chunks,
                smem=h1_smem_bytes(C, S, pp, stats))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def head_reference(x_flat: torch.Tensor, bias: torch.Tensor, w: torch.Tensor,
                   G: int, lam: float = LAMBDA, gate: bool = True) -> torch.Tensor:
    """Plain bias + SimAM + grouped head dot over a flat (B, H, W, G*C) map
    (``pallas_simam_head._reference``); w (C, F)."""
    from .simam import simam_flat
    xb = x_flat + bias.to(x_flat.dtype).repeat(G)
    if gate:
        xb = simam_flat(xb, G, lam)
    B, H, W, GC = xb.shape
    C = GC // G
    y = xb.reshape(B, H, W, G, C).float() @ w.to(x_flat.dtype).float()
    return y.reshape(B, H, W, G * w.shape[1]).to(x_flat.dtype)


def reference(x, enc, bias, w, up_factor: int, ksize: int = 3,
              lam: float = LAMBDA, gate: bool = True) -> torch.Tensor:
    """Plain version of the whole head (``pallas_carafe_head._reference``)."""
    up = pixel_unshuffle(carafe.carafe_reassemble(x, enc, up_factor, ksize), up_factor)
    return head_reference(up, bias, w, up_factor * up_factor, lam, gate)


def _head_terms(fb, dy, mu, v, w, G, lam):
    """(x, x - mu, g, dg, t) in float32 over (B, H, W, G, C) views: the
    gate terms of the forward and the head dot's cotangent dg."""
    B, H, W, GC = fb.shape
    C = GC // G
    xf = fb.float().reshape(B, H, W, G, C)
    dyf = dy.float().reshape(B, H, W, G, -1)
    dg = dyf @ w.to(fb.dtype).float().t()
    xc = xf - mu[:, None, None, None, :]
    g = torch.sigmoid(xc * xc / (4.0 * (v[:, None, None, None, :] + lam)) + 0.5)
    return xf, dyf, xc, g, dg, dg * xf * g * (1.0 - g)


def head_bwd1_reference(fb, dy, mu, v, w, G: int, lam: float = LAMBDA,
                        gate: bool = True):
    """Plain K3 (``pallas_simam_head._bwd1_kernel`` + the pooling of
    ``head_bwd1_pallas``): A, B (B, C) pooled per real channel and dW (C, F),
    all float32, for the biased flat map fb (B, H, W, G*C), the logits'
    cotangent dy (B, H, W, G*F), mu, v (B, C) and w (C, F).  Without the
    gate (``_bwd1_nogate_kernel``) A and B are None and dW pairs fb with dy."""
    if not gate:
        B, H, W, GC = fb.shape
        return None, None, torch.einsum("bhwgc,bhwgf->cf",
                                        fb.float().reshape(B, H, W, G, GC // G),
                                        dy.float().reshape(B, H, W, G, -1))
    xf, dyf, xc, g, _, t = _head_terms(fb, dy, mu, v, w, G, lam)
    gated = (xf * g).to(fb.dtype).float()
    return ((t * xc).sum(dim=(1, 2, 3)), (t * xc * xc).sum(dim=(1, 2, 3)),
            torch.einsum("bhwgc,bhwgf->cf", gated, dyf))


def head_bwd2_reference(fb, dy, mu, v, A, Bq, w, G: int, lam: float = LAMBDA,
                        gate: bool = True):
    """Plain K5 (``pallas_simam_head._bwd2_kernel``): the head's elementwise
    VJP dacc = d(biased flat map) from the closed-form SimAM VJP, for fb, dy,
    mu, v and w as :func:`head_bwd1_reference` takes them and K3's pooled A,
    B (B, C) -> (dacc like fb, db (C,) float32 summed before the rounding).
    Without the gate (``_bwd2_nogate_kernel``) dacc = dy kron(I_G, W^T) and
    mu, v, A, B are unused."""
    B, H, W, GC = fb.shape
    if gate:
        xf, _, xc, g, dg, t = _head_terms(fb, dy, mu, v, w, G, lam)
        w4 = 1.0 / (4.0 * (v[:, None, None, None, :] + lam))
        N = H * W * G
        dacc = (dg * g + 2.0 * w4 * t * xc - (2.0 * w4 / N) * A[:, None, None, None, :]
                - (8.0 * w4 * w4 / max(N - 1, 1)) * Bq[:, None, None, None, :] * xc)
    else:
        dacc = dy.float().reshape(B, H, W, G, -1) @ w.to(fb.dtype).float().t()
    return dacc.reshape(B, H, W, GC).to(fb.dtype), dacc.sum(dim=(0, 1, 2, 3))


def fused_head_bwd_reference(x, enc, fb, dy, mu, v, A, Bq, w, up_factor: int,
                             lam: float = LAMBDA, gate: bool = True):
    """Plain K4 (``pallas_carafe_head._fused_bwd_kernel``): the head's
    elementwise VJP dacc (:func:`head_bwd2_reference`), rounded to the
    compute dtype, through the CARAFE backward -> (dx, denc, db), db (C,)
    float32 summed before the rounding."""
    dacc, db = head_bwd2_reference(fb, dy, mu, v, A, Bq, w, up_factor * up_factor, lam, gate)
    dx, denc = carafe.carafe_bwd_reference(x, enc, dacc.to(x.dtype), up_factor)
    return dx, denc, db


def carafe_biased_moments(x: torch.Tensor, enc: torch.Tensor, bias: torch.Tensor,
                          up_factor: int, gate: bool = True):
    """K-H1: (fb, s1, s2) with fb the biased flat map (B, H, W, S^2*C) and
    s1, s2 (B, chunks, C) float32 sums of fb and fb^2 per real channel over
    each block's chunk of pixels and all S^2 sub-pixels (:func:`h1_geometry`;
    None when ``gate`` is False): ``s1.sum(1)`` is the (B, C) sum that
    ``pooled_stats(..., groups=1)`` takes."""
    check_carafe_args(x, enc, up_factor, 3)
    B, H, W, C = x.shape
    S = up_factor
    bias = bias.to(x.dtype).contiguous()
    if bias.shape != (C,) or bias.device != x.device:
        raise ValueError(f"bias must be ({C},) on {x.device}")
    fb = torch.empty(B, H, W, S * S * C, dtype=x.dtype, device=x.device)
    vec = _build.vec_width(x, fb, bias, channels=C)
    geom = h1_geometry(B, H, W, C, S, vec, _sms(x.device), stats=gate)
    s1 = s2 = None
    if gate:
        s1 = torch.empty(B, geom["chunks"], C, dtype=torch.float32, device=x.device)
        s2 = torch.empty_like(s1)
    _build.launch(MOMENTS_KERNEL, x.device, _build.dtype_code(x), x.data_ptr(),
                  enc.data_ptr(), bias.data_ptr(), fb.data_ptr(),
                  s1.data_ptr() if gate else None, s2.data_ptr() if gate else None,
                  B, H, W, C, S, vec, geom["pass_pixels"], geom["pixels"])
    return fb, s1, s2


def simam_head_flat(fb: torch.Tensor, mu: torch.Tensor | None, v: torch.Tensor | None,
                    w: torch.Tensor, G: int, lam: float = LAMBDA,
                    gate: bool = True) -> torch.Tensor:
    """K-H2: flat logits (B, H, W, G*F) from the biased flat map fb
    (B, H, W, G*C), the per-real-channel (mu, v) as (B, C) float32, and the
    head weight w (C, F), F <= 8."""
    B, H, W, GC = fb.shape
    C = GC // G
    Fc = w.shape[1]
    if w.shape != (C, Fc) or not 1 <= Fc <= MAX_CLASSES:
        raise ValueError(f"w must be ({C}, F) with F <= {MAX_CLASSES}, got {tuple(w.shape)}")
    wt = w.to(fb.dtype).contiguous()
    if gate:
        if mu is None or v is None or mu.shape != (B, C) or v.shape != (B, C):
            raise ValueError(f"mu and v must be ({B}, {C})")
        mu = mu.float().contiguous()
        v = v.float().contiguous()
        _build.check_cuda(mu, v)
    _build.check_cuda(fb, wt)
    out = torch.empty(B, H, W, G * Fc, dtype=fb.dtype, device=fb.device)
    vec = _build.vec_width(fb, channels=C)
    geom = h2_geometry(B, H, W, C, G, vec, _sms(fb.device))
    _build.launch(HEAD_KERNEL, fb.device, _build.dtype_code(fb), fb.data_ptr(),
                  mu.data_ptr() if gate else None, v.data_ptr() if gate else None,
                  wt.data_ptr(), out.data_ptr(), B, H, W, C, G, Fc, vec, geom["lanes"],
                  float(lam), int(gate), geom["pixels"])
    return out


def _check_head_grads(fb, dy, mu, v, w, G, gate=True):
    B, H, W, GC = fb.shape
    C = GC // G
    Fc = w.shape[1]
    if w.shape != (C, Fc) or not 1 <= Fc <= MAX_CLASSES:
        raise ValueError(f"w must be ({C}, F) with F <= {MAX_CLASSES}, got {tuple(w.shape)}")
    if dy.shape != (B, H, W, G * Fc):
        raise ValueError(f"dy must be {(B, H, W, G * Fc)}, got {tuple(dy.shape)}")
    _build.check_cuda(fb, dy)
    if gate:
        for name, t in (("mu", mu), ("v", v)):
            if t.shape != (B, C) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be ({B}, {C}) float32")
        _build.check_cuda(mu, v)


def head_bwd1(fb, dy, mu, v, w, G: int, lam: float = LAMBDA, gate: bool = True):
    """K3 on CUDA tensors, :func:`head_bwd1_reference` on CPU ones:
    (A, B, dW) float32, A and B (B, C) pooled per real channel.  Without the
    gate, K3 without the gate: (None, None, dW), mu and v unused."""
    if fb.device.type == "cpu":
        return head_bwd1_reference(fb, dy, mu, v, w, G, lam, gate)
    dy = dy.contiguous()
    _check_head_grads(fb, dy, mu, v, w, G, gate)
    B, H, W, _ = fb.shape
    C, Fc = w.shape
    vec = _build.vec_width(fb, channels=C)
    slot_split(G * (C // vec))  # raises where the grid cannot hold the slices
    geom = k3_geometry(B, H, W, _sms(fb.device))
    pc = geom["pixels"]
    # one row of partial sums a block, image-major: A, B (with the gate), then
    # dW by class, each over (G, C); one reduction over chunks and G
    rows = (2 if gate else 0) + Fc
    part = torch.empty(B, geom["chunks"], rows, G, C, dtype=torch.float32, device=fb.device)
    dtype = _build.dtype_code(fb)
    if not gate:
        _build.launch(BWD1_NOGATE_KERNEL, fb.device, dtype, fb.data_ptr(), dy.data_ptr(),
                      part.data_ptr(), B, H, W, C, G, Fc, vec, pc)
        return None, None, part.sum(dim=(0, 1, 3)).t().contiguous()
    wt = w.to(fb.dtype).contiguous()
    _build.launch(BWD1_KERNEL, fb.device, dtype, fb.data_ptr(),
                  dy.data_ptr(), mu.data_ptr(), v.data_ptr(), wt.data_ptr(), part.data_ptr(),
                  B, H, W, C, G, Fc, vec, float(lam), pc)
    sums = part.sum(dim=(1, 3))  # (B, 2 + F, C)
    return sums[:, 0], sums[:, 1], sums[:, 2:].sum(dim=0).t().contiguous()


def fused_head_bwd(x, enc, fb, dy, mu, v, A, Bq, w, up_factor: int, lam: float = LAMBDA,
                   gate: bool = True, tile: tuple[int, int] | None = None):
    """K4 on CUDA tensors, :func:`fused_head_bwd_reference` on CPU ones:
    (dx like x, denc like enc, db (C,) float32).  Without the gate, K4
    without the gate, which reads neither fb nor mu, v, A, Bq.  ``tile`` =
    (rows, px) sets K4's block (:func:`k4_geometry`)."""
    if x.device.type == "cpu":
        return fused_head_bwd_reference(x, enc, fb, dy, mu, v, A, Bq, w, up_factor, lam,
                                        gate)
    check_carafe_args(x, enc, up_factor, 3)
    S = up_factor
    G = S * S
    B, H, W, C = x.shape
    if fb.shape != (B, H, W, G * C) or fb.dtype != x.dtype:
        raise ValueError(f"fb must be {(B, H, W, G * C)} {x.dtype}")
    dy = dy.contiguous()
    _check_head_grads(fb, dy, mu, v, w, G, gate)
    wt = w.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    denc = torch.empty_like(enc)
    vec = _build.vec_width(x, fb, dx, channels=C)
    Fc = w.shape[1]
    geom = k4_geometry(B, H, W, C, S, vec, x.element_size(), Fc, gate, _sms(x.device), tile)
    blocks, px, rows = geom["blocks"], geom["px"], geom["rows"]
    db_part = torch.empty(blocks, G * C, dtype=torch.float32, device=x.device)
    if gate:
        A, Bq = A.float().contiguous(), Bq.float().contiguous()
        if A.shape != (B, C) or Bq.shape != (B, C):
            raise ValueError(f"A and B must be ({B}, {C})")
        _build.launch(FUSED_BWD_KERNEL, x.device, _build.dtype_code(x), x.data_ptr(),
                      enc.data_ptr(), fb.data_ptr(), dy.data_ptr(), wt.data_ptr(),
                      mu.data_ptr(), v.data_ptr(), A.data_ptr(), Bq.data_ptr(),
                      dx.data_ptr(), denc.data_ptr(), db_part.data_ptr(), B, H, W, C, S,
                      Fc, vec, px, rows, float(lam))
    else:
        _build.launch(FUSED_BWD_NOGATE_KERNEL, x.device, _build.dtype_code(x), x.data_ptr(),
                      enc.data_ptr(), dy.data_ptr(), wt.data_ptr(), dx.data_ptr(),
                      denc.data_ptr(), db_part.data_ptr(), B, H, W, C, S, Fc, vec, px, rows)
    return dx, denc, db_part.reshape(blocks * G, C).sum(dim=0)


def _forward(x, enc, bias, w, S, lam, gate):
    """(logits, fb, mu, v) of the fused head; mu, v are None without gate."""
    B, H, W, _ = x.shape
    G = S * S
    if x.device.type == "cpu":
        fb = carafe.carafe_flat(x, enc, S) + bias.to(x.dtype).repeat(G)
        mu = v = None
        if gate:
            f = fb.float()
            mu, v = pooled_stats(f.sum(dim=(1, 2)), (f * f).sum(dim=(1, 2)), H * W * G, G)
        return head_reference(fb, torch.zeros_like(bias), w, G, lam, gate), fb, mu, v
    fb, s1, s2 = carafe_biased_moments(x, enc, bias, S, gate)
    mu = v = None
    if gate:  # K-H1's sums are per real channel already
        mu, v = pooled_stats(s1.sum(dim=1), s2.sum(dim=1), H * W * G, 1)
    return simam_head_flat(fb, mu, v, w, G, lam, gate), fb, mu, v


class CarafeSimamHead(torch.autograd.Function):
    """The fused head: K-H1 + K-H2 forward, K3 + K4 backward on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, enc, bias, w, up_factor, lam, gate):
        out, fb, mu, v = _forward(x, enc, bias, w, up_factor, lam, gate)
        ctx.up_factor, ctx.lam, ctx.gate = up_factor, lam, gate
        ctx.save_for_backward(x, enc, bias, w, fb, mu, v)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, enc, bias, w, fb, mu, v = ctx.saved_tensors
        S, lam, gate = ctx.up_factor, ctx.lam, ctx.gate
        A, Bq, dW = head_bwd1(fb, dy, mu, v, w, S * S, lam, gate)
        dx, denc, db = fused_head_bwd(x, enc, fb, dy, mu, v, A, Bq, w, S, lam, gate)
        return dx, denc, db.to(bias.dtype), dW.to(w.dtype), None, None, None


def carafe_simam_head(x: torch.Tensor, enc: torch.Tensor, bias: torch.Tensor,
                      w: torch.Tensor, up_factor: int, ksize: int = 3,
                      lam: float = LAMBDA, gate: bool = True) -> torch.Tensor:
    """x (B, H, W, C) low-res map after the out-conv's linear part, enc
    (B, H, W, 9*S^2) kernel logits, bias (C,), w (C, F) with F <= 8 ->
    flat logits (B, H, W, S^2*F) in x's dtype, lane ``s*F + f``;
    differentiable."""
    if w.shape[-1] > MAX_CLASSES:
        raise ValueError(f"carafe_simam_head takes at most {MAX_CLASSES} classes, "
                         f"got {w.shape[-1]}")
    if ksize != 3:
        raise ValueError(f"the CARAFE kernels take ksize 3, got {ksize}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return CarafeSimamHead.apply(x, enc, bias, w, up_factor, lam, gate)
