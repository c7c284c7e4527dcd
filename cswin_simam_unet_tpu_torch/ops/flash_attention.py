"""The flash-attention kernel family: KV-tiled attention for long windows,
forward and backward.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_attention_flash.py``.
Three CUDA kernels (``csrc/flash_attention_{fwd,dq,dkv}.cu``) run in two
modes, counted apart in ``_build.LAUNCHES`` (``<entry>:window`` and
``<entry>:flash``):

* **flash** (:func:`stripe_attention_flash`, windows of more than
  :data:`FLASH_MIN_TOKENS` tokens, as ``models/layers.py:188`` routes
  them): the band layout of ``stripe_attention_pallas_flash`` (vertical
  stripes transposed into horizontal bands, ``:432``), attention without
  LePE through :class:`FlashAttention`, and the LePE added outside by the
  plain depthwise conv (``:452``); the dropout mask is
  ``hash_keep_mask`` over tiles of :func:`pick_tile` in band order, and
  delta = rowsum(dO * O) per head is a torch op (``:319-320``).
* **window** (the tiled K-A and K-A' of ``ops/stripe_attention.py``, for
  windows of up to 2048 tokens that one block cannot hold): LePE fused,
  the whole-window mask convention (one N x N tile per window and head)
  and delta computed by the dq kernel.

:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`
are the plain versions of the flash path, with its rounding points: q *
scale rounded to the compute dtype before the product, the unnormalised
probabilities dropped and rounded before p.v, O rounded before the LePE is
added.  The CPU path uses them; nothing on the card's main path does.
"""

from __future__ import annotations

import torch

from .. import _build
from . import attention
from .dropout import hash_keep_mask, kernel_drop_args, u32_threshold

FWD_KERNEL = "csu_flash_attention_fwd"
DQ_KERNEL = "csu_flash_attention_dq"
DKV_KERNEL = "csu_flash_attention_dkv"
HEAD_DIMS = (8, 16, 32, 64)
FLASH_MIN_TOKENS = 2048  # windows of more tokens take the flash path
TILE = 512               # pallas_attention_flash._TILE


def pick_tile(N: int, target: int = TILE) -> int:
    """``pallas_attention_flash._pick_tile``: the largest divisor of N that
    is at most ``target``, preferring multiples of 8; the flash path's
    dropout-mask tile."""
    cap = min(N, target)
    aligned = [t for t in range(8, cap + 1, 8) if N % t == 0]
    if aligned:
        return aligned[-1]
    return max(t for t in range(1, cap + 1) if N % t == 0)


def rows_per_block(head_dim: int) -> int:
    """Rows (query rows, or key rows in dk/dv) of one block of the family:
    a thread per row, two at head dim 64 (csrc/flash_attention.cuh)."""
    return 128 if head_dim <= 32 else 64


def check_args(q, k, v, lepe_kernel, H, W, hsp, wsp, num_heads) -> int:
    """Validate a kernel call's arguments (``lepe_kernel`` may be None);
    returns the head dim."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, L, C = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
    if L != H * W or H % hsp or W % wsp:
        raise ValueError(f"bad window geometry L={L} H={H} W={W} hsp={hsp} wsp={wsp}")
    if C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"head dim {C}/{num_heads} not in {HEAD_DIMS}")
    _build.dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v dtypes differ")
    tensors = (k, v) if lepe_kernel is None else (k, v, lepe_kernel)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and lepe_kernel must be on one device")
    if lepe_kernel is not None and lepe_kernel.shape != (3, 3, 1, C):
        raise ValueError(f"lepe_kernel must be (3, 3, 1, {C}), got {tuple(lepe_kernel.shape)}")
    return C // num_heads


def _mask_tile(mode: str, N: int) -> int:
    """The dropout mask's tile edge: one N x N tile per window in window
    mode, :func:`pick_tile` in flash mode."""
    if mode not in ("window", "flash"):
        raise ValueError(f"unknown mode {mode!r}")
    return N if mode == "window" else pick_tile(N)


def _taps(mode: str, lepe_kernel, dtype):
    """The LePE taps the kernel fuses (window mode), or None (flash mode)."""
    if (lepe_kernel is None) != (mode == "flash"):
        raise ValueError("window mode fuses the LePE (lepe_kernel required); flash mode "
                         "adds it outside (lepe_kernel=None)")
    return None if lepe_kernel is None else attention.lepe_taps(lepe_kernel, dtype)


def kernel_fwd(q, k, v, lepe_kernel, *, H, W, hsp, wsp, num_heads, scale=None,
               attn_drop=0.0, seed=None, mode):
    """The forward kernel on CUDA tensors: (out (B, L, C) in q's dtype, L
    (B * windows, N, heads) float32)."""
    head_dim = check_args(q, k, v, lepe_kernel, H, W, hsp, wsp, num_heads)
    B, L, C = q.shape
    N = hsp * wsp
    taps = _taps(mode, lepe_kernel, q.dtype)
    ldq, ldk, ldv = _build.token_strides((q, "q"), (k, "k"), (v, "v"))
    out = torch.empty(B, L, C, dtype=q.dtype, device=q.device)
    lse = torch.empty(B * (H // hsp) * (W // wsp), N, num_heads, dtype=torch.float32,
                      device=q.device)
    if scale is None:
        scale = head_dim ** -0.5
    _build.launch(FWD_KERNEL, q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), None if taps is None else taps.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), ldq, ldk, ldv, B, H, W, hsp, wsp, num_heads, head_dim,
                  float(scale), _mask_tile(mode, N), *kernel_drop_args(attn_drop, seed),
                  mode=mode)
    return out, lse


def _bwd_args(q, k, v, lepe_kernel, lse, dout, delta, H, W, hsp, wsp, num_heads, scale,
              attn_drop, seed, mode):
    """Validated arguments shared by the dq and dk/dv kernels: (dout with
    usable strides, the shape arguments, the row strides)."""
    head_dim = check_args(q, k, v, lepe_kernel, H, W, hsp, wsp, num_heads)
    N, n_win = hsp * wsp, q.shape[0] * (H // hsp) * (W // wsp)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must be like q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if _build.token_stride(dout) is None:
        dout = dout.contiguous()
    stats = (n_win, N, num_heads)
    for t, name in ((lse, "lse"), (delta, "delta")):
        if t is not None and (tuple(t.shape) != stats or t.dtype != torch.float32
                              or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous float32 {stats} on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if scale is None:
        scale = head_dim ** -0.5
    shape = (q.shape[0], H, W, hsp, wsp, num_heads, head_dim, float(scale),
             _mask_tile(mode, N), *kernel_drop_args(attn_drop, seed))
    strides = _build.token_strides((q, "q"), (k, "k"), (v, "v"), (dout, "dout"))
    return dout, shape, strides


def kernel_dq(q, k, v, lse, dout, *, H, W, hsp, wsp, num_heads, scale=None, attn_drop=0.0,
              seed=None, delta=None, mode):
    """The dq kernel on CUDA tensors: (dq contiguous in q's dtype, delta).
    Flash mode takes ``delta`` = rowsum(dO * O) per head, (B * windows, N,
    heads) float32; window mode computes it here and returns it for
    :func:`kernel_dkv`."""
    if (delta is not None) != (mode == "flash"):
        raise ValueError("flash mode takes delta; window mode computes it")
    dout, shape, strides = _bwd_args(q, k, v, None, lse, dout, delta, H, W, hsp, wsp,
                                     num_heads, scale, attn_drop, seed, mode)
    delta_given = delta is not None
    if delta is None:
        delta = torch.empty_like(lse)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _build.launch(DQ_KERNEL, q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  int(delta_given), dq.data_ptr(), *strides, *shape, mode=mode)
    return dq, delta


def kernel_dkv(q, k, v, lepe_kernel, lse, delta, dout, *, H, W, hsp, wsp, num_heads,
               scale=None, attn_drop=0.0, seed=None, mode):
    """The dk/dv kernel on CUDA tensors: (dk, dv) contiguous in q's dtype
    and, in window mode, dw (3, 3, 1, C) in lepe_kernel's dtype (None in
    flash mode)."""
    dout, shape, strides = _bwd_args(q, k, v, lepe_kernel, lse, dout, delta, H, W, hsp, wsp,
                                     num_heads, scale, attn_drop, seed, mode)
    taps = _taps(mode, lepe_kernel, q.dtype)
    B, L, C = q.shape
    dk, dv = (torch.empty(B, L, C, dtype=q.dtype, device=q.device) for _ in range(2))
    dw_part = None
    if taps is not None:
        n_blocks = lse.shape[0] * -(-lse.shape[1] // rows_per_block(C // num_heads))
        dw_part = torch.empty(n_blocks, 9, C, dtype=torch.float32, device=q.device)
    _build.launch(DKV_KERNEL, q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), None if taps is None else taps.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  None if dw_part is None else dw_part.data_ptr(), *strides, *shape, mode=mode)
    if dw_part is None:
        return dk, dv, None
    return dk, dv, dw_part.sum(dim=0).reshape(3, 3, 1, C).to(lepe_kernel.dtype)


def kernel_bwd(q, k, v, lepe_kernel, lse, dout, *, delta=None, mode, **geometry):
    """The dq and dk/dv kernels on CUDA tensors for the output cotangent
    ``dout`` and the forward's ``lse``, ``attn_drop`` and ``seed``: (dq, dk,
    dv) contiguous in q's dtype and, in window mode, dw (3, 3, 1, C) in
    lepe_kernel's dtype (None in flash mode).  Flash mode takes ``delta``;
    window mode computes it in the dq kernel."""
    dq, delta = kernel_dq(q, k, v, lse, dout, **geometry, delta=delta, mode=mode)
    return (dq, *kernel_dkv(q, k, v, lepe_kernel, lse, delta, dout, **geometry, mode=mode))


# ---- the plain flash path, on bands (G, N, Cb) ----

def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(G, N, C) -> (G, heads, N, C / heads) float32."""
    G, N, C = x.shape
    return x.reshape(G, N, heads, C // heads).permute(0, 2, 1, 3).float()


def _unheads(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    G, h, N, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(G, N, h * d).to(dtype)


def _scaled_q(qb: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """round(q * scale) to the compute dtype, as float32 heads."""
    return (_heads(qb, heads) * scale).to(qb.dtype).float()


def _tile_keep(attn_drop: float, seed: int | None, G: int, heads: int, N: int, T: int,
               device):
    """A function of the key tile's first column giving the keep mask of
    that tile's columns for all rows, (G, heads, N, T) bool, and the
    rescale; None without dropout."""
    threshold = u32_threshold(attn_drop)
    if not threshold:
        return None
    if seed is None:
        raise ValueError("attention dropout needs a seed")
    g = torch.arange(G, device=device)[:, None, None, None]
    h = torch.arange(heads, device=device)[None, :, None, None]
    rows = torch.arange(N, device=device)[None, None, :, None]

    def keep(j0: int) -> torch.Tensor:
        cols = torch.arange(j0, j0 + T, device=device)[None, None, None, :]
        return hash_keep_mask(seed, g, h, rows, cols, threshold, T)

    return keep, 1.0 / (1.0 - attn_drop)


def flash_delta(out: torch.Tensor, dout: torch.Tensor, heads: int) -> torch.Tensor:
    """rowsum(dO * O) per head in float32: (..., N, C) -> (..., N, heads)."""
    prod = dout.float() * out.float()
    return prod.reshape(*prod.shape[:-1], heads, -1).sum(dim=-1)


def flash_attention_reference(qb, kb, vb, *, heads: int, scale: float | None = None,
                              attn_drop: float = 0.0, seed: int | None = None):
    """``_flash_fwd_bands`` in plain PyTorch on bands (G, N, Cb): (O (G, N,
    Cb) in the compute dtype, L (G, N, heads) float32), the online softmax
    swept over key tiles of :func:`pick_tile`."""
    G, N, Cb = qb.shape
    if scale is None:
        scale = (Cb // heads) ** -0.5
    T = pick_tile(N)
    drop = _tile_keep(attn_drop, seed, G, heads, N, T, qb.device)
    qs, kh, vh = _scaled_q(qb, heads, scale), _heads(kb, heads), _heads(vb, heads)
    m = torch.full((G, heads, N, 1), -torch.inf, device=qb.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qs)
    for j0 in range(0, N, T):
        s = torch.matmul(qs, kh[:, :, j0:j0 + T].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if drop is not None:
            keep, inv_keep = drop
            p = torch.where(keep(j0), p * inv_keep, torch.zeros((), device=p.device))
        acc = alpha * acc + torch.matmul(p.to(qb.dtype).float(), vh[:, :, j0:j0 + T])
        m = m_new
    lse = (m + torch.log(l))[..., 0].permute(0, 2, 1).contiguous()
    return _unheads(acc / l, qb.dtype), lse


def flash_attention_bwd_reference(qb, kb, vb, out, lse, dout, *, heads: int,
                                  scale: float | None = None, attn_drop: float = 0.0,
                                  seed: int | None = None):
    """``_flash_bwd_bands`` in plain PyTorch: (dq, dk, dv) (G, N, Cb) in the
    compute dtype from the forward's O and L and the cotangent ``dout``;
    delta = rowsum(dO * O) per head, p = exp(s - L)."""
    G, N, Cb = qb.shape
    if scale is None:
        scale = (Cb // heads) ** -0.5
    T = pick_tile(N)
    drop = _tile_keep(attn_drop, seed, G, heads, N, T, qb.device)
    L = lse.permute(0, 2, 1)[..., None]
    delta = flash_delta(out, dout, heads).permute(0, 2, 1)[..., None]
    qs, qu = _scaled_q(qb, heads, scale), _heads(qb, heads)
    kh, vh, gh = _heads(kb, heads), _heads(vb, heads), _heads(dout, heads)
    dq = torch.zeros_like(qu)
    dk, dv = torch.empty_like(qu), torch.empty_like(qu)
    for j0 in range(0, N, T):
        kt, vt = kh[:, :, j0:j0 + T], vh[:, :, j0:j0 + T]
        p = torch.exp(torch.matmul(qs, kt.transpose(-1, -2)) - L)
        dp = torch.matmul(gh, vt.transpose(-1, -2))
        pd = p
        if drop is not None:
            keep, inv_keep = drop
            mask = keep(j0)
            zero = torch.zeros((), device=p.device)
            pd = torch.where(mask, p * inv_keep, zero)
            dp = torch.where(mask, dp * inv_keep, zero)
        ds = (p * (dp - delta)).to(qb.dtype).float()
        dq += torch.matmul(ds, kt)
        dk[:, :, j0:j0 + T] = torch.matmul(ds.transpose(-1, -2), qu)
        dv[:, :, j0:j0 + T] = torch.matmul(pd.to(qb.dtype).float().transpose(-1, -2), gh)
    return (_unheads(dq * scale, qb.dtype), _unheads(dk * scale, qb.dtype),
            _unheads(dv, qb.dtype))


# ---- the flash path ----

def _bands(x: torch.Tensor, geometry: dict) -> torch.Tensor:
    """(B, L, C) tokens of full-width bands -> (G, N, C), a view."""
    B, L, C = x.shape
    return x.reshape(B * (geometry["H"] // geometry["hsp"]), geometry["hsp"] * geometry["W"], C)


class FlashAttention(torch.autograd.Function):
    """Attention without LePE over full-width bands of (B, H*W, C) tokens
    (``geometry``: H, W, hsp, wsp == W, num_heads, scale, attn_drop, seed):
    the flash kernels on CUDA tensors, the plain flash versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, geometry):
        ctx.geometry = geometry
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(
                _bands(q, geometry), _bands(k, geometry), _bands(v, geometry),
                heads=geometry["num_heads"], scale=geometry["scale"],
                attn_drop=geometry["attn_drop"], seed=geometry["seed"])
            out = out.reshape(q.shape)
        else:
            out, lse = kernel_fwd(q, k, v, None, **geometry, mode="flash")
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        geo = ctx.geometry
        if q.device.type == "cpu":
            grads = flash_attention_bwd_reference(
                *(_bands(t, geo) for t in (q, k, v, out)), lse, _bands(dout, geo),
                heads=geo["num_heads"], scale=geo["scale"], attn_drop=geo["attn_drop"],
                seed=geo["seed"])
            return (*(g.reshape(q.shape) for g in grads), None)
        delta = flash_delta(_bands(out, geo), _bands(dout, geo), geo["num_heads"])
        dq, dk, dv, _ = kernel_bwd(q, k, v, None, lse, dout, **geo, delta=delta,
                                   mode="flash")
        return dq, dk, dv, None


def band_geometry(H: int, W: int, hsp: int, wsp: int) -> tuple[bool, int, int, int]:
    """(flip, H', W', band height) of ``stripe_attention_pallas_flash``:
    vertical stripes (hsp == H, wsp < W) become horizontal bands of the
    transposed grid; every window must then span the full width."""
    flip = hsp == H and wsp < W
    Ht, Wt, wht, wst = (W, H, wsp, hsp) if flip else (H, W, hsp, wsp)
    if wst != Wt:
        raise ValueError(f"the flash path takes stripes and global windows, got "
                         f"{hsp}x{wsp} windows of a {H}x{W} grid")
    return flip, Ht, Wt, wht


def stripe_attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lepe_kernel: torch.Tensor, *, H: int, W: int, hsp: int,
                           wsp: int, num_heads: int, scale: float | None = None,
                           attn_drop: float = 0.0, seed: int | None = None) -> torch.Tensor:
    """``stripe_attention_pallas_flash``: flash attention over the band
    layout, plus the LePE of the plain depthwise conv; (B, L, C) tokens in
    and out, lepe_kernel (3, 3, 1, C); differentiable."""
    B, L, C = q.shape
    flip, Ht, Wt, wht = band_geometry(H, W, hsp, wsp)

    def transpose(x, rows, cols):  # (B, rows*cols, C) -> its (cols, rows) transpose
        return x.reshape(B, rows, cols, C).transpose(1, 2).reshape(B, L, C)

    if flip:
        q, k, v_b = (transpose(t, H, W) for t in (q, k, v))
    else:
        v_b = v
    if scale is None:
        scale = (C // num_heads) ** -0.5
    geometry = dict(H=Ht, W=Wt, hsp=wht, wsp=Wt, num_heads=num_heads, scale=float(scale),
                    attn_drop=attn_drop, seed=seed)
    attn = FlashAttention.apply(q, k, v_b, geometry)
    if flip:
        attn = transpose(attn, Ht, Wt)
    return attn + attention.lepe_tokens(v, lepe_kernel, H, W, hsp, wsp)
