"""2-D spatial sharding of the UNet: the image's height over the ranks of a
``('spatial',)`` mesh.

Counterpart of ``cswin_simam_unet_tpu/parallel/spatial.py``.  Rank r holds
rows ``[r H/n, (r + 1) H/n)`` of every NHWC image (an H-slab; :func:`shard_rows`
takes it from a global tensor, :func:`gather_rows` puts the slabs back
together), every op runs on its slab, and the only communication is

* a **halo exchange** with the two neighbour ranks (:func:`halo_pad`) for
  each convolution that reads across a slab's edge: the neighbours' edge
  rows, zeros at the image's top and bottom;
* an **all-gather** of K and V (one, of the two side by side) over the
  ranks for the attention windows that span every slab (vertical stripes
  and the global window, :func:`spatial_stripe_attention`);
* **sums over the ranks** (``mesh.all_reduce_sum``) of the moments of
  BatchNorm and SimAM, which are the whole image's.

Max-pool 2x2/s2 and the k2/s2 transpose convolutions never cross an even
row boundary, and 1x1 convolutions are per pixel, so they are slab-local;
activation memory is O(H / n) a rank.  Each collective is an autograd
Function whose backward is its transpose (the reverse shift, the sum of the
ranks' gradients of a gathered tensor, the sum of the ranks' gradients of a
summed moment), so the gradients of a loss summed over the slabs reach each
rank's slab exactly; a parameter's gradient is the sum of the ranks'
``.grad`` (all-reduce it, as the data-parallel step does).

:func:`spatial_unet_apply` interprets the port's :class:`..models.UNet`
op for op over its own parameters and buffers, so no second model
definition can drift from it.  In train mode BatchNorm normalises with the
moments of the global batch and, as in JAX, moves no running statistics.

Every collective is an ``all_gather`` (the halo exchange gathers every
rank's edge rows and takes its neighbours') or an ``all_reduce``: gloo,
which two ranks sharing a card run, takes CUDA tensors in those and not in
its point-to-point calls.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import attention, stripe_attention
from ..ops.dropout import hash_keep_mask, u32_threshold
from ..ops.simam import LAMBDA, gate
from ..ops.windows import img2windows, windows2img
from .mesh import Mesh, all_reduce_sum

# the UNet's max-pool levels: a slab must keep whole, even rows at each
LEVELS = 4
BN_EPS = 1e-5


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows ``[r H/n, (r + 1) H/n)`` of a global tensor whose
    H is dim 1 (NHWC images, (B, H, W, C) token grids), contiguous."""
    rows = x.shape[1] // mesh.size
    if rows * mesh.size != x.shape[1]:
        raise ValueError(f"{x.shape[1]} rows do not split over {mesh.size} ranks")
    return x[:, mesh.rank * rows:(mesh.rank + 1) * rows].contiguous()


class _GatherRows(torch.autograd.Function):
    """Every rank's slab, concatenated in rank order along H (dim 1).  Each
    rank may use the gathered tensor its own way (its own queries against
    the gathered keys), so the gradient of a rank's slab is the sum over the
    ranks of their gradients of its rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[1]
        if mesh.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        total = ctx.mesh.all_reduce_(grad.contiguous().clone())
        return total[:, ctx.mesh.rank * ctx.rows:(ctx.mesh.rank + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global tensor from the ranks' slabs (the inverse of
    :func:`shard_rows`), on every rank; differentiable."""
    return _GatherRows.apply(x, mesh)


def _exchange(up: torch.Tensor, down: torch.Tensor, mesh: Mesh):
    """Send ``up`` to the rank above (r - 1) and ``down`` to the rank below
    (r + 1); returns (what the rank above sent down, what the rank below
    sent up), zeros where there is no such rank.  One all-gather of every
    rank's edge rows: gloo's point-to-point calls take no CUDA tensors (two
    ranks sharing a card run gloo), its all-gather does, and edge rows are
    small."""
    zeros = lambda t: torch.zeros(t.shape, dtype=t.dtype, device=t.device)  # noqa: E731
    from_above, from_below = zeros(down), zeros(up)
    if mesh.size == 1:
        return from_above, from_below
    parts = [torch.empty(up.numel() + down.numel(), dtype=up.dtype, device=up.device)
             for _ in range(mesh.size)]
    dist.all_gather(parts, torch.cat([up.reshape(-1), down.reshape(-1)]))
    r = mesh.rank
    if r > 0:
        from_above = parts[r - 1][up.numel():].view(down.shape)
    if r < mesh.size - 1:
        from_below = parts[r + 1][:up.numel()].view(up.shape)
    return from_above, from_below


class _HaloPad(torch.autograd.Function):
    """``top`` rows from the rank above and ``bot`` rows from the rank below
    around this rank's slab (H is dim 1); the backward shifts the halos'
    gradients back and adds each onto the sender's edge rows."""

    @staticmethod
    def forward(ctx, x, top, bot, mesh):
        ctx.top, ctx.bot, ctx.mesh = top, bot, mesh
        H = x.shape[1]
        if top > H or bot > H:
            raise ValueError(f"a halo of {top} / {bot} rows around a slab of {H}")
        # my last rows are the rank below's top halo, my first the rank above's bottom
        above, below = _exchange(x[:, :bot], x[:, H - top:], mesh)
        return torch.cat([above, x, below], 1)

    @staticmethod
    def backward(ctx, grad):
        top, bot = ctx.top, ctx.bot
        H = grad.shape[1] - top - bot
        g = grad[:, top:top + H].clone()
        from_above, from_below = _exchange(grad[:, :top], grad[:, top + H:], ctx.mesh)
        g[:, H - top:] += from_below
        g[:, :bot] += from_above
        return g, None, None, None


def halo_pad_asym(x: torch.Tensor, top: int, bot: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slab with ``top`` rows of the rank above and ``bot`` rows
    of the rank below around it (zeros at the image's edges, the zero
    padding of the global image), differentiable."""
    if top == 0 and bot == 0:
        return x
    return _HaloPad.apply(x, top, bot, mesh)


def halo_pad(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """:func:`halo_pad_asym` with ``halo`` rows each way."""
    return halo_pad_asym(x, halo, halo, mesh)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC map as the NCHW view cuDNN takes channels-last (no copy)."""
    return x.permute(0, 3, 1, 2)


def spatial_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                 stride: int, pad: int, mesh: Mesh) -> torch.Tensor:
    """A k x k conv of stride s and zero padding p on an H-slab (NHWC; weight
    (out, in, k, k)): output row i reads input rows [s i - p, s i - p + k),
    so the halo is p rows above and k - p - s below."""
    k = weight.shape[-1]
    xp = halo_pad_asym(x, pad, k - pad - stride, mesh)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv2d(_nchw(xp), weight.to(x.dtype), b, stride=stride, padding=(0, pad))
    return y.permute(0, 2, 3, 1).contiguous()


def spatial_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                    mesh: Mesh) -> torch.Tensor:
    """SAME 3x3 stride-1 conv on an H-slab (halo 1)."""
    return spatial_conv(x, weight, bias, 1, 1, mesh)


def _psum_moments(x: torch.Tensor, mesh: Mesh):
    """(mean, biased variance) per channel over (N, H, W) of every rank's
    slab, in float32 (or x's wider dtype): ``var = E[x^2] - E[x]^2`` as JAX
    computes it (no clamp at 0)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = (0, 1, 2)
    s = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims)]), mesh)
    n = x.numel() // x.shape[-1] * mesh.size
    mean, mean_sq = s.split(x.shape[-1])
    mean, mean_sq = mean / n, mean_sq / n
    return mean, mean_sq - mean * mean


def spatial_batchnorm(x: torch.Tensor, bn, mesh: Mesh, train: bool) -> torch.Tensor:
    """BatchNorm (``bn``: the port's ``models.unet.BatchNorm``) on an NHWC
    H-slab.  Eval: the running statistics.  Train: the moments of the global
    batch over (N, H, W), summed over the ranks; the running statistics are
    not moved.  Float32 math, or x's wider dtype."""
    ct = torch.promote_types(x.dtype, torch.float32)
    if train:
        mean, var = _psum_moments(x, mesh)
    else:
        mean, var = bn.running_mean.to(ct), bn.running_var.to(ct)
    inv = torch.rsqrt(var + BN_EPS) * bn.weight.to(ct)
    return ((x.to(ct) - mean) * inv + bn.bias.to(ct)).to(x.dtype)


def spatial_simam(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """SimAM (``ops/simam.py``, float32 math) on an NHWC H-slab, each
    (batch, channel)'s moments over the whole H x W plane: n = H W - 1 of
    the global image."""
    H, W = x.shape[1], x.shape[2]
    xf = x.float()
    s = all_reduce_sum(torch.cat([xf.sum((1, 2), keepdim=True),
                                  (xf * xf).sum((1, 2), keepdim=True)], -1), mesh)
    s1, s2 = s.split(x.shape[-1], -1)
    N = H * W * mesh.size
    mu = s1 / N
    v = (s2 - N * mu * mu) / max(N - 1, 1)
    return gate(x, mu, v, LAMBDA)


def _double_conv(block, x, mesh: Mesh, train: bool):
    """``models.unet.DoubleConv``: (3x3 conv -> BatchNorm -> ReLU) x 2, then
    SimAM where the block has it."""
    conv1, bn1, _, conv2, bn2, _ = block.double_conv
    for conv, bn in ((conv1, bn1), (conv2, bn2)):
        x = torch.relu(spatial_batchnorm(spatial_conv3x3(x, conv.weight, conv.bias, mesh), bn,
                                         mesh, train))
    return spatial_simam(x, mesh) if block.use_simam else x


def _down(block, x, mesh: Mesh, train: bool):
    """2x2 max-pool (slab-local: even rows) then a DoubleConv."""
    y = F.max_pool2d(_nchw(x), 2).permute(0, 2, 3, 1)
    return _double_conv(block.maxpool_conv[1], y, mesh, train)


def _up(block, x, skip, mesh: Mesh, train: bool):
    """k2 s2 transpose conv (slab-local), ``cat([skip, x])`` (skip first),
    then a DoubleConv."""
    up = block.up
    y = F.conv_transpose2d(_nchw(x), up.weight.to(x.dtype), up.bias.to(x.dtype), stride=2)
    y = torch.cat([skip, y.permute(0, 2, 3, 1)], dim=-1)
    return _double_conv(block.conv, y, mesh, train)


def _unet_forward(model, x, mesh: Mesh, train: bool):
    """``models.unet.UNet.forward`` op for op on one H-slab (NHWC)."""
    skips = [_double_conv(model.inc, x, mesh, train)]
    for i in range(1, LEVELS + 1):
        skips.append(_down(getattr(model, f"down{i}"), skips[-1], mesh, train))
    y = skips.pop()
    for i in range(1, LEVELS + 1):
        y = _up(getattr(model, f"up{i}"), y, skips.pop(), mesh, train)
    w = model.outc.weight[:, :, 0, 0].to(y.dtype)
    return F.linear(y, w, model.outc.bias.to(y.dtype))


def _window_heads(wins: torch.Tensor, num_heads: int) -> torch.Tensor:
    Bw, N, C = wins.shape
    return wins.reshape(Bw, N, num_heads, C // num_heads).permute(0, 2, 1, 3)


def spatial_stripe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             lepe_kernel: torch.Tensor, *, H: int, W: int, hsp: int,
                             wsp: int, num_heads: int, mesh: Mesh,
                             scale: float | None = None, attn_drop: float = 0.0,
                             seed: int | None = None) -> torch.Tensor:
    """Cross-shaped-window attention with LePE on H-sharded tokens: ``q, k,
    v`` (B, L_local, C) are rows [r H/n, (r + 1) H/n) of the (H, W) token
    grid; the semantics of ``ops.attention.stripe_attention`` over the
    global grid.

    * Horizontal stripes (hsp < H): every window lies within one slab when
      H/n divides by hsp; they run on the slab as they would on the image,
      through ``ops.stripe_attention.stripe_attention`` (K-A / K-A', or the
      tiled pair, on CUDA tensors), the dropout mask
      keyed on each window's number in the image (``win0``,
      ``nwin_global``).
    * Vertical stripes and the global window (hsp == H): every window spans
      every slab, so K and V are all-gathered over the ranks and Q stays
      local: softmax(q_local k^T) v for this rank's rows, in plain PyTorch
      (JAX leaves this to XLA too; no kernel takes fewer queries than
      keys), the dropout mask the rows [r H/n wsp, ...) of each whole
      window's.  The LePE is the depthwise conv of the gathered V stripe
      (zero padded at the window's edge), its local rows sliced out.

    ``attn_drop > 0`` drops scores with the keep mask of ``seed``: an
    N-rank run draws the bits a 1-rank run draws, which are those of
    ``ops.attention.stripe_attention`` over the whole image."""
    B, L_local, C = q.shape
    n = mesh.size
    H_local = H // n
    if L_local != H_local * W or H_local * n != H:
        raise ValueError(f"local token count {L_local} != {H_local}*{W} (H={H}, n_shards={n})")
    d_head = C // num_heads
    if scale is None:
        scale = d_head ** -0.5

    if hsp < H:
        if H_local % hsp:
            raise ValueError(
                f"horizontal stripe height {hsp} must divide the local slab "
                f"height {H_local} (H={H}, n_shards={n})")
        nwin = (H_local // hsp) * (W // wsp)
        return stripe_attention.stripe_attention(
            q, k, v, lepe_kernel, H=H_local, W=W, hsp=hsp, wsp=wsp, num_heads=num_heads,
            scale=scale, attn_drop=attn_drop, seed=seed, win0=mesh.rank * nwin,
            nwin_global=n * nwin)

    # K and V in one all-gather
    k_full, v_full = gather_rows(torch.cat([k, v], -1).reshape(B, H_local, W, 2 * C),
                                 mesh).split(C, -1)
    q_wins = img2windows(q.reshape(B, H_local, W, C), H_local, wsp)
    v_wins = img2windows(v_full, H, wsp)
    qh = _window_heads(q_wins, num_heads)
    kh = _window_heads(img2windows(k_full, H, wsp), num_heads)
    vh = _window_heads(v_wins, num_heads)
    Bw, N = v_wins.shape[:2]
    row0 = mesh.rank * H_local
    lepe = attention.lepe_depthwise(v_wins, lepe_kernel, H, wsp).reshape(Bw, H, wsp, C)
    lepe_h = _window_heads(lepe[:, row0:row0 + H_local].reshape(Bw, H_local * wsp, C),
                           num_heads)

    attn = torch.softmax(torch.matmul((qh * scale).float(), kh.float().transpose(-1, -2)), -1)
    threshold = u32_threshold(attn_drop)
    if threshold:
        if seed is None:
            raise ValueError("attention dropout needs a seed")
        dev = q.device
        keep = hash_keep_mask(
            seed, torch.arange(Bw, device=dev)[:, None, None, None],
            torch.arange(num_heads, device=dev)[None, :, None, None],
            row0 * wsp + torch.arange(H_local * wsp, device=dev)[None, None, :, None],
            torch.arange(N, device=dev)[None, None, None, :], threshold, N)
        attn = torch.where(keep, attn * (1.0 / (1.0 - attn_drop)), torch.zeros((), device=dev))
    out = torch.matmul(attn.to(q.dtype).float(), vh.float()).to(q.dtype) + lepe_h
    out = out.permute(0, 2, 1, 3).reshape(Bw, H_local * wsp, C)
    return windows2img(out, H_local, wsp, H_local, W).reshape(B, L_local, C)


def validate_spatial_geometry(height: int, n_shards: int) -> None:
    """The UNet's pool pyramid keeps whole, even rows on every slab only if
    H divides by n_shards * 2^levels."""
    step = n_shards * (2 ** LEVELS)
    if height % step != 0:
        raise ValueError(
            f"spatial sharding needs H divisible by n_shards * 2^levels = "
            f"{step} (got H={height}, n_shards={n_shards}); pad the input "
            f"or reduce the spatial axis")


def spatial_unet_apply(model, x: torch.Tensor, mesh: Mesh, train: bool = False) -> torch.Tensor:
    """The UNet's forward with H sharded over ``mesh``: ``x`` is this rank's
    H-slab (B, H/n, W, C) of the images, the result its slab of the logits
    (B, H/n, W, classes) in the model's dtype.  Equal to ``model.forward(x,
    train=train)`` on the whole images, apart from float rounding; in train
    mode the running statistics stay as they are."""
    validate_spatial_geometry(x.shape[1] * mesh.size, mesh.size)
    if x.shape[2] % 2 ** LEVELS:
        raise ValueError(f"UNet: width {x.shape[2]} must divide by {2 ** LEVELS}")
    return _unet_forward(model, x.to(model.device, model.dtype).contiguous(), mesh, train)
