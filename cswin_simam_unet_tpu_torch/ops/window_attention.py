"""Kernels K-V1 and K-V1': v1 window attention on pre-partitioned windows,
forward and backward, and the v1 stripe-attention entry.

Counterpart of ``cswin_simam_unet_tpu/ops/pallas_attention.py``:
:func:`window_attention` is softmax attention over (G, Np, D) window groups
whose keys at or past ``n_valid`` are masked (token padding), with no LePE
and no dropout (``pallas_attention.py:52-107``).  It is a
``torch.autograd.Function``: on CUDA tensors its forward launches K-V1
(``csrc/window_attention.cu``, ``csu_window_attention_fwd``, replacing
``_fwd_kernel``), which also keeps each row's log-sum-exp, and its backward
K-V1' (``csu_window_attention_bwd``, replacing ``_bwd_kernel``); on CPU
tensors both take the plain versions, :func:`window_attention_reference`
and :func:`window_attention_bwd_reference`, at v1's rounding points (q, k,
v and the cotangent widened to float32, q * scale not rounded, the
probabilities kept in float32, one rounding of each output).  Windows of
more than 2048 tokens raise, as the TPU kernel's N x N score block in VMEM
goes no further.

On the H100 each score costs an exp on the SFU and, on the CUDA cores, more
float32 FMAs than one SDPA call takes in all, so bf16 at head dims 16, 32
and 64 runs on the tensor cores (``mma.sync``; the launch counts
``_build.BODY_LAUNCHES["<entry>:mma"]``) and float32 and head dim 8 on the
CUDA cores (``":fma"``), as K-A picks.  The C entry picks K-V1''s body
(:func:`design`): a window whose q, k, v, dO and ds^T fit one block's
shared memory (at most 256 tokens at head dims 16 and 32, 208 at 64) takes
the whole-window body, one launch with everything in shared memory; longer
windows take the flash family's tiled dq and dk/dv bodies with the key
count.  In bf16 round(q * scale), p and ds become bf16 mma operands, where
v1 keeps them in float32 (``ROADMAP.md``, Queue C).  :func:`launch_geometry`
mirrors the blocks each kernel launches.

:func:`stripe_attention_v1` is the drop-in ``stripe_attention_pallas``:
windows padded to a multiple of 16 tokens, the LePE added outside the
kernel, the padding sliced off.  Its one fallback is the JAX function's
documented contract: with attention dropout active in training
(``attn_drop > 0`` and ``deterministic=False``) it runs the plain
:func:`..attention.stripe_attention`, since v1 has no dropout in the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .attention import lepe_depthwise, stripe_attention, window_heads
from .flash_attention import HEAD_DIMS, kernel_body, rows_aligned
from .windows import img2windows, tokens_to_nhwc, windows2img

FWD_KERNEL = "csu_window_attention_fwd"
BWD_KERNEL = "csu_window_attention_bwd"
MAX_TOKENS = 2048
PAD = 16  # tokens are padded to a multiple of the bf16 sublane tile
MASKED = -1e30
MMA_HEAD_DIMS = (16, 32, 64)  # bf16 at these head dims: the tensor-core bodies
WHOLE_MAX_ROWS = 256          # csrc/window_attention.cu kV1WholeMaxRows
MAX_SMEM = 227 * 1024         # csrc/common.cuh kMaxSmem
MMA_ROWS, MMA_THREADS = 64, 128     # a tensor-core block's own rows, threads
FMA_THREADS = 128                   # csrc/flash_attention.cuh kFlashThreads


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def whole_smem(D: int, Np: int, n_valid: int) -> int:
    """Shared memory of the whole-window K-V1' block (``v1_whole_smem``):
    round(q * scale), k, v and dO in rows of D + 8 bf16, L and delta in
    float32, ds^T in rows of round16(Np) + 8 bf16."""
    Npad = _round16(Np)
    return 4 * Npad * (D + 8) * 2 + 2 * Npad * 4 + _round16(n_valid) * (Npad + 8) * 2


def design(dtype: torch.dtype, D: int, Np: int) -> str:
    """K-V1''s body for (dtype, head dim, Np), as the C entry picks it
    (``csu_window_attention_design``): "fma" (the CUDA-core bodies: float32
    and head dim 8), "whole" (bf16, the block holds the window) or "tiled"
    (bf16, the flash family's dq and dk/dv bodies).  K-V1 runs the
    tensor-core forward wherever this is not "fma"."""
    if dtype != torch.bfloat16 or D not in MMA_HEAD_DIMS:
        return "fma"
    fits = _round16(Np) <= WHOLE_MAX_ROWS and whole_smem(D, Np, Np) <= MAX_SMEM
    return "whole" if fits else "tiled"


def launch_geometry(dtype: torch.dtype, G: int, Np: int, n_valid: int, D: int) -> dict:
    """The launches of K-V1 ("fwd") and K-V1' ("bwd": one or two kernels) at
    one shape, each as (grid, threads, dynamic shared-memory bytes), as the
    C side configures them."""
    body = design(dtype, D, Np)
    if body == "fma":  # a thread a row, two lanes a row at head dim 64
        rows = FMA_THREADS // (2 if D > 32 else 1)
        blk = ((G, -(-Np // rows), 1), FMA_THREADS, 0)
        return dict(body=body, fwd=blk, bwd=[blk, blk])
    tiles = ((G, 1, -(-Np // MMA_ROWS)), MMA_THREADS)
    tile_bytes = MMA_ROWS * (D + 8) * 2
    fwd = (*tiles, 5 * tile_bytes)  # the query tile, two stages of k and v
    if body == "whole":
        bwd = [((G, 1, 1), 2 * _round16(Np), whole_smem(D, Np, n_valid))]
    else:  # dq: q, dO, two stages of k and v; dk/dv: two stages of q, q * scale, dO, L, delta
        bwd = [(*tiles, 6 * tile_bytes), (*tiles, 6 * tile_bytes + 4 * MMA_ROWS * 4)]
    return dict(body=body, fwd=fwd, bwd=bwd)


def _scores(q, k, scale, n_valid):
    """(q * scale) . k^T in float32, keys at or past n_valid set to -1e30."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if n_valid < s.shape[-1]:
        s = s.masked_fill(torch.arange(s.shape[-1], device=s.device) >= n_valid, MASKED)
    return s


def window_attention_reference(q, k, v, scale: float, n_valid: int) -> torch.Tensor:
    """Plain K-V1 (``pallas_attention._fwd_kernel``): (G, Np, D) in q's dtype."""
    p = torch.softmax(_scores(q, k, scale, n_valid), dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def window_attention_bwd_reference(q, k, v, dout, scale: float, n_valid: int):
    """Plain K-V1' (``pallas_attention._bwd_kernel``): (dq, dk, dv) in q's
    dtype for the output cotangent ``dout``."""
    p = torch.softmax(_scores(q, k, scale, n_valid), dim=-1)
    do = dout.float()
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * scale)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(q, k, v, n_valid) -> None:
    """The shape contract of both directions, on every device."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one (G, Np, D) shape, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    G, Np, D = q.shape
    if Np > MAX_TOKENS:
        raise ValueError(f"v1 window attention takes at most {MAX_TOKENS} tokens per "
                         f"window (the TPU kernel's N x N block), got {Np}")
    if not 1 <= n_valid <= Np:
        raise ValueError(f"n_valid must be in [1, {Np}], got {n_valid}")


def _kernel_args(q, *rest):
    """Contiguous, 16-byte aligned copies (where needed) of q and the
    tensors of its shape, checked for one CUDA device and dtype; the head dim
    checked."""
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    ts = [t.contiguous() for t in (q, *rest)]
    _build.check_cuda(*ts)
    return [rows_aligned(t) for t in ts]


def kernel_fwd(q, k, v, scale: float, n_valid: int):
    """K-V1 on CUDA tensors: (out like q, log-sum-exp (G, Np) float32)."""
    _check(q, k, v, n_valid)
    q, k, v = _kernel_args(q, k, v)
    G, Np, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(G, Np, dtype=torch.float32, device=q.device)
    _build.launch(FWD_KERNEL, q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), lse.data_ptr(), G, Np, D, n_valid,
                  float(scale), body=kernel_body(q, D))
    return out, lse


def kernel_bwd(q, k, v, lse, dout, scale: float, n_valid: int):
    """K-V1' on CUDA tensors: (dq, dk, dv) like q, from the forward's
    log-sum-exp ``lse`` (the body of :func:`design`)."""
    _check(q, k, v, n_valid)
    q, k, v, dout = _kernel_args(q, k, v, dout)
    G, Np, D = q.shape
    if lse.shape != (G, Np) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be ({G}, {Np}) float32 on {q.device}")
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _build.launch(BWD_KERNEL, q.device, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), dout.data_ptr(), lse.contiguous().data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), G, Np, D,
                  n_valid, float(scale), body=kernel_body(q, D))
    return dq, dk, dv


class WindowAttention(torch.autograd.Function):
    """v1 window attention whose forward and backward are K-V1 and K-V1' on
    CUDA tensors and the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale, n_valid):
        ctx.scale, ctx.n_valid = scale, n_valid
        lse = None
        if q.device.type == "cpu":
            out = window_attention_reference(q, k, v, scale, n_valid)
        else:
            out, lse = kernel_fwd(q, k, v, scale, n_valid)
        ctx.save_for_backward(q, k, v, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        if lse is None:
            grads = window_attention_bwd_reference(q, k, v, dout, ctx.scale, ctx.n_valid)
        else:
            grads = kernel_bwd(q, k, v, lse, dout, ctx.scale, ctx.n_valid)
        return (*grads, None, None)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     n_valid: int) -> torch.Tensor:
    """softmax(scale q k^T) v over (G, Np, D) window groups, keys at or past
    ``n_valid`` masked; differentiable."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, n_valid)
    return WindowAttention.apply(q, k, v, float(scale), int(n_valid))


def _pad_tokens(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    return x if x.shape[1] == n_pad else F.pad(x, (0, 0, 0, n_pad - x.shape[1]))


def stripe_attention_v1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lepe_kernel: torch.Tensor, *, H: int, W: int, hsp: int, wsp: int,
                        num_heads: int, scale: float | None = None, attn_drop: float = 0.0,
                        deterministic: bool = True, seed: int | None = None) -> torch.Tensor:
    """``stripe_attention_pallas``: one attention branch over (B, L, C)
    tokens with windows (hsp, wsp) and LePE, through :func:`window_attention`;
    returns (B, L, C) in image order.  With ``attn_drop > 0`` and
    ``deterministic=False`` (training with attention dropout) it returns the
    plain :func:`..attention.stripe_attention` with the keep mask of
    ``seed`` instead, as the JAX function falls back to its XLA path."""
    if attn_drop > 0.0 and not deterministic:
        return stripe_attention(q, k, v, lepe_kernel, H=H, W=W, hsp=hsp, wsp=wsp,
                                num_heads=num_heads, scale=scale, attn_drop=attn_drop,
                                seed=seed)
    B, L, C = q.shape
    d_head = C // num_heads
    if scale is None:
        scale = d_head ** -0.5
    N = hsp * wsp
    n_pad = -(-N // PAD) * PAD

    def to_gnd(x):
        heads = window_heads(x, hsp, wsp, H, W, num_heads)  # (B', heads, N, d)
        return _pad_tokens(heads.reshape(-1, N, d_head), n_pad)

    v_wins = img2windows(tokens_to_nhwc(v, H, W), hsp, wsp)  # (B', N, C)
    lepe = lepe_depthwise(v_wins, lepe_kernel, hsp, wsp)
    Bw = v_wins.shape[0]
    o = window_attention(to_gnd(q), to_gnd(k), to_gnd(v), float(scale), N)[:, :N]
    o = o.reshape(Bw, num_heads, N, d_head).permute(0, 2, 1, 3).reshape(Bw, N, C) + lepe
    return windows2img(o, hsp, wsp, H, W).reshape(B, L, C)
