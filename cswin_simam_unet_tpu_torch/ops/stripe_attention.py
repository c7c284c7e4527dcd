"""Kernels K-A and K-A': stripe / global window attention with LePE,
forward and backward, and the dispatch of every window size.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_attention_v2.py::
stripe_attention_pallas_v2`` and its custom VJP (``_branch_attention``),
and of the dispatch by window size in ``models/layers.py:187-200``.
:func:`stripe_attention` picks, for N = hsp * wsp tokens per window:

* N <= 2048 and the window fits one block's shared memory in both K-A and
  K-A' (:func:`whole_window`; at head dim 32, N <= 384): the whole-window
  kernels K-A (``csrc/stripe_attention.cu``) and K-A'
  (``csrc/stripe_attention_bwd.cu``).  In bf16 at head dims 16, 32 and 64
  both run tensor-core bodies: K-A saves each row's log-sum-exp L, and K-A'
  launches the tiled K-A' dq and dk/dv bodies at the whole-window mask,
  from one C call;
* N <= 2048 otherwise: the tiled K-A / K-A', the window mode of the
  flash-attention family (:mod:`.flash_attention`): the same function,
  the same mask, LePE fused, the forward's log-sum-exp saved for the
  backward;
* N > 2048: the flash path, :func:`.flash_attention.stripe_attention_flash`.

The forward picks the family whose backward can run the window, so a
forward and its backward are always a pair.  :class:`StripeAttention` is a
``torch.autograd.Function``; on CPU tensors both directions take the plain
versions in :mod:`cswin_simam_unet_tpu_torch.ops.attention`.  The kernels
read q, k and v where they lie: each may be a column slice of a wider token
tensor (rows with a fixed stride), such as the thirds of one qkv projection,
and vertical stripes are read in place, not transposed.

Attention dropout (``attn_drop > 0``) takes a host integer ``seed``: the
kernels recompute each score's keep bit from the counter hash of
(seed, window, head, query token, key token) (``ops/dropout.py``), the
Function keeps the seed for its backward, and the plain versions build the
same mask, so kernel and plain drop the same scores.  ``attn_drop == 0``
launches the kernels without the hash.  ``win0`` and ``nwin_global`` key
the mask on the windows' numbers in a whole image of which the call's grid
is an H-slab (``ops/dropout.py::mask_windows``; the spatial sharding's
horizontal stripes), ``head0`` on the heads' numbers in a layer of which the
call's heads are heads [head0, head0 + num_heads) (a rank's own heads under
tensor parallelism, ``parallel/sharding.py``); the defaults number the
windows and heads as the call does.
"""

from __future__ import annotations

import torch

from .. import _build
from . import attention, flash_attention
from .dropout import kernel_drop_args

KERNEL = "csu_stripe_attention_fwd"
BWD_KERNEL = "csu_stripe_attention_bwd"
TILED_KERNEL = f"{flash_attention.FWD_KERNEL}:window"
TILED_BWD_KERNELS = (f"{flash_attention.DQ_KERNEL}:window",
                     f"{flash_attention.DKV_KERNEL}:window")
_SMEM_LIMIT = 227 * 1024
_WARPS = 8


def smem_bytes(N: int, head_dim: int) -> int:
    """Shared memory of one K-A block: K (padded) and V of the window, one
    score row per warp."""
    return 4 * (N * (head_dim + 1) + N * head_dim + _WARPS * N)


def smem_bytes_bwd(N: int, head_dim: int, body: str = "fma") -> int:
    """Shared memory of one K-A' block.  The CUDA-core body ("fma"): Q, K, V
    and dO of the window (rows padded), three row statistics, two rows of N
    per warp.  The tensor-core bodies ("mma"), the larger of the two
    kernels' blocks: six tiles of 64 rows of head_dim bf16 padded to
    head_dim + 8, and dq's keep bits (a word per thread and 64-key tile) or
    dk/dv's two stages of L and delta."""
    if body == "fma":
        return 4 * (4 * N * (head_dim + 1) + 3 * N + 2 * _WARPS * N)
    return 6 * 64 * (head_dim + 8) * 2 + max(-(-N // 64) * 128 * 4, 4 * 64 * 4)


def whole_window(N: int, head_dim: int) -> bool:
    """Whether K-A and K-A' both hold a window of N tokens in one block."""
    return max(smem_bytes(N, head_dim), smem_bytes_bwd(N, head_dim)) <= _SMEM_LIMIT


def _check(q, k, v, lepe_kernel, H, W, hsp, wsp, num_heads, smem) -> tuple[int, str]:
    """Validate a whole-window kernel call's arguments; returns the head dim
    and the body the entry launches for them.  ``smem(N, head_dim, body)``:
    one block's shared memory."""
    head_dim = flash_attention.check_args(q, k, v, lepe_kernel, H, W, hsp, wsp, num_heads)
    body = flash_attention.kernel_body(q, head_dim)
    if smem(hsp * wsp, head_dim, body) > _SMEM_LIMIT:
        raise ValueError(f"window of {hsp * wsp} tokens does not fit one block's "
                         "shared memory")
    return head_dim, body


def attention_fwd(q, k, v, lepe_kernel, *, H, W, hsp, wsp, num_heads, scale=None,
                  attn_drop=0.0, seed=None, with_lse=False, win0=0, nwin_global=None,
                  head0=0):
    """K-A on CUDA tensors: (B, L, C) tokens in and out, lepe_kernel (3, 3, 1, C).
    bf16 at head dims 16, 32 and 64 runs the tensor-core body ("mma", counted
    in ``_build.BODY_LAUNCHES``), which takes q, k and v with 16-byte aligned
    rows (copied where they are not); float32 and head dim 8 the CUDA-core
    body ("fma").  With ``with_lse``: (out, L), L the log-sum-exp of each
    window's rows, (B * windows, N, heads) float32, which the tensor-core
    K-A' reads, written by the tensor-core body (None from the CUDA-core
    body, whose K-A' does not read it)."""
    head_dim, body = _check(q, k, v, lepe_kernel, H, W, hsp, wsp, num_heads,
                            lambda N, D, _: smem_bytes(N, D))
    if body == "mma":
        q, k, v = (flash_attention.rows_aligned(t) for t in (q, k, v))
    drop = kernel_drop_args(attn_drop, seed, win0, nwin_global, head0)
    B, L, C = q.shape
    ldq, ldk, ldv = _build.token_strides((q, "q"), (k, "k"), (v, "v"))
    taps = attention.lepe_taps(lepe_kernel, q.dtype)
    out = torch.empty(B, L, C, dtype=q.dtype, device=q.device)
    lse = None
    if with_lse and body == "mma":
        lse = torch.empty(B * (H // hsp) * (W // wsp), hsp * wsp, num_heads,
                          dtype=torch.float32, device=q.device)
    if scale is None:
        scale = head_dim ** -0.5
    _build.launch(KERNEL, q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), taps.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), ldq, ldk, ldv, C, B, H, W, hsp,
                  wsp, num_heads, head_dim, float(scale), *drop, body=body)
    return (out, lse) if with_lse else out


def attention_bwd(q, k, v, lepe_kernel, dout, *, H, W, hsp, wsp, num_heads, scale=None,
                  attn_drop=0.0, seed=None, lse=None, win0=0, nwin_global=None, head0=0):
    """(dq, dk, dv, dw) of :func:`attention_fwd` for the output cotangent
    ``dout`` and the forward's ``attn_drop`` and ``seed``: K-A' on CUDA
    tensors, the plain version on CPU tensors.  dq, dk, dv come out
    contiguous in q's dtype, dw (3, 3, 1, C) in lepe_kernel's.  The
    tensor-core body (bf16 at head dims 16, 32 and 64) needs the forward's
    ``lse`` (``attention_fwd(..., with_lse=True)``) and raises without it;
    the CUDA-core body does not read it."""
    kw = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=num_heads, scale=scale,
              attn_drop=attn_drop, seed=seed, win0=win0, nwin_global=nwin_global,
              head0=head0)
    if q.device.type == "cpu":
        return attention.stripe_attention_bwd_reference(q, k, v, lepe_kernel, dout, **kw)
    head_dim, body = _check(q, k, v, lepe_kernel, H, W, hsp, wsp, num_heads, smem_bytes_bwd)
    drop = kernel_drop_args(attn_drop, seed, win0, nwin_global, head0)
    B, L, C = q.shape
    N, n_win = hsp * wsp, B * (H // hsp) * (W // wsp)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must be like q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if _build.token_stride(dout) is None:
        dout = dout.contiguous()
    delta, n_part = None, n_win
    if body == "mma":
        stats = (n_win, N, num_heads)
        if lse is None or (tuple(lse.shape) != stats or lse.dtype != torch.float32
                           or not lse.is_contiguous() or lse.device != q.device):
            raise ValueError(f"the tensor-core K-A' needs the forward's lse, contiguous "
                             f"float32 {stats} on {q.device} (attention_fwd(..., "
                             f"with_lse=True)), got "
                             f"{None if lse is None else (tuple(lse.shape), lse.dtype)}")
        q, k, v, dout = (flash_attention.rows_aligned(t) for t in (q, k, v, dout))
        delta = torch.empty_like(lse)
        n_part = n_win * -(-N // flash_attention.rows_per_block(head_dim, body))
    else:
        lse = None
    ldq, ldk, ldv, ldg = _build.token_strides((q, "q"), (k, "k"), (v, "v"), (dout, "dout"))
    taps = attention.lepe_taps(lepe_kernel, q.dtype)
    dq, dk, dv = (torch.empty(B, L, C, dtype=q.dtype, device=q.device) for _ in range(3))
    dw_part = torch.empty(n_part, 9, C, dtype=torch.float32, device=q.device)
    if scale is None:
        scale = head_dim ** -0.5
    _build.launch(BWD_KERNEL, q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), taps.data_ptr(), dout.data_ptr(),
                  None if lse is None else lse.data_ptr(),
                  None if delta is None else delta.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), dw_part.data_ptr(), ldq, ldk, ldv, ldg, B,
                  H, W, hsp, wsp, num_heads, head_dim, float(scale), *drop, body=body)
    dw = dw_part.sum(dim=0).reshape(3, 3, 1, C).to(lepe_kernel.dtype)
    return dq, dk, dv, dw


def tiled_fwd(q, k, v, lepe_kernel, **geometry):
    """The tiled K-A on CUDA tensors, any window of up to 2048 tokens: (out,
    log-sum-exp per window, row and head)."""
    return flash_attention.kernel_fwd(q, k, v, lepe_kernel, **geometry, mode="window")


def tiled_bwd(q, k, v, lepe_kernel, lse, dout, **geometry):
    """The tiled K-A' on CUDA tensors: (dq, dk, dv, dw) as :func:`attention_bwd`
    gives them, from the forward's log-sum-exp ``lse``."""
    return flash_attention.kernel_bwd(q, k, v, lepe_kernel, lse, dout, **geometry,
                                      mode="window")


class StripeAttention(torch.autograd.Function):
    """Window attention + LePE for windows of up to 2048 tokens whose forward
    and backward are K-A and K-A', or the tiled pair, on CUDA tensors and the
    plain versions on CPU tensors.  ``geometry`` holds the window geometry
    and the dropout's rate and seed, which the backward reuses; K-A writes
    its L for K-A' only where ``recorded`` (a backward can follow)."""

    @staticmethod
    def forward(ctx, q, k, v, lepe_kernel, geometry, recorded):
        ctx.geometry = geometry
        lse = None
        ctx.whole = whole_window(geometry["hsp"] * geometry["wsp"],
                                 q.shape[-1] // geometry["num_heads"])
        if q.device.type == "cpu":
            out = attention.stripe_attention(q, k, v, lepe_kernel, **geometry)
        elif ctx.whole and recorded:
            out, lse = attention_fwd(q, k, v, lepe_kernel, **geometry, with_lse=True)
        elif ctx.whole:
            out = attention_fwd(q, k, v, lepe_kernel, **geometry)
        else:
            out, lse = tiled_fwd(q, k, v, lepe_kernel, **geometry)
        ctx.save_for_backward(q, k, v, lepe_kernel, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lepe_kernel, lse = ctx.saved_tensors
        if ctx.whole or q.device.type == "cpu":
            dq, dk, dv, dw = attention_bwd(q, k, v, lepe_kernel, dout, **ctx.geometry,
                                           lse=lse)
        else:
            dq, dk, dv, dw = tiled_bwd(q, k, v, lepe_kernel, lse, dout, **ctx.geometry)
        return dq, dk, dv, dw, None, None


def stripe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lepe_kernel: torch.Tensor, *, H: int, W: int, hsp: int,
                     wsp: int, num_heads: int, scale: float | None = None,
                     attn_drop: float = 0.0, seed: int | None = None, win0: int = 0,
                     nwin_global: int | None = None, head0: int = 0) -> torch.Tensor:
    """softmax(scale q k^T) v + LePE(v) per window and head, the scores
    dropped at rate ``attn_drop`` by the keep mask of ``seed`` (its windows
    numbered from ``win0`` among ``nwin_global`` an image, its heads from
    ``head0``); (B, L, C)
    tokens in and out, lepe_kernel (3, 3, 1, C); differentiable.  Windows
    of more than 2048 tokens take the flash path."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    geometry = dict(H=H, W=W, hsp=hsp, wsp=wsp, num_heads=num_heads, scale=scale,
                    attn_drop=attn_drop, seed=seed, win0=win0, nwin_global=nwin_global,
                    head0=head0)
    if hsp * wsp > flash_attention.FLASH_MIN_TOKENS:
        return flash_attention.stripe_attention_flash(q, k, v, lepe_kernel, **geometry)
    recorded = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, lepe_kernel))
    return StripeAttention.apply(q, k, v, lepe_kernel, geometry, recorded)
