"""2-D spatial sharding of the CSWin(-SimAM)-UNet: the image's height over
the ranks of a ``('spatial',)`` mesh, forward and backward.

Counterpart of ``cswin_simam_unet_tpu/parallel/spatial_cswin.py``, built on
:mod:`.spatial`.  Rank r holds rows [r H/n, (r + 1) H/n) of every image and
of every stage's token grid; the communication is

* **halo exchanges** for the stem (7x7/s4/p2: 2 rows from above, 1 from
  below), the merges (3x3/s2/p1: 1 from above), each CARAFE's encoder conv
  (3x3: 1 each way) and its reassembly's 1-row neighbourhood;
* **K/V all-gathers** for the windows that span the slabs (vertical stripes
  and the global window of the last stage); horizontal stripes stay on
  their slab;
* **sums over the ranks** of SimAM's per-channel moments.

LayerNorm, the qkv / projection / MLP matmuls, the residuals, the skips and
the 1x1 head are per token.  :func:`spatial_cswin_apply` interprets the
port's :class:`..models.CSWinUNet` op for op over its own modules and
parameters.  On CUDA tensors the horizontal stripes run on
K-A / K-A' (the tiled pair above ``ops.stripe_attention.whole_window``'s
size) and each CARAFE reassembly, the head's x4 included, on K-C / K-C';
the gathered windows are plain matmuls, as JAX leaves them to XLA.  The head
is the plain CARAFE x4 + SimAM + 1x1 conv: the fused head (K-H1, K-H2, K3,
K4) pools its SimAM moments per image and does not run on a slab.

Train mode (``train=True`` with a ``seed``) draws every mask keyed on global
positions, so an N-rank run draws exactly the bits a 1-rank run draws:

* token dropout (after the patch embed, twice in each MLP): the keep mask
  drawn at the global token shape from the forward's generator, this rank's
  tokens sliced out;
* drop-path: per sample, the same draw on every rank;
* attention dropout: one seed an attention call (``DropoutRng.next_seed``,
  drawn at every call); a horizontal window's mask keyed on its number in
  the image (``b * nwin_global + win0 + w``), a gathered window's on the
  global query row (``row0 * wsp + n`` in the window's h-major order).

The draws are those of ``CSWinUNet.forward(x, train=True, rng=seed)`` in
the same order, so a 1-rank run drops what the model drops.  The stream is
the port's own, not JAX's ``jax.random`` one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops import carafe_kernels
from ..ops.dropout import DropoutRng, drop_path, fast_dropout, keep_mask
from ..ops.windows import nhwc_to_tokens
from .mesh import Mesh
from .spatial import halo_pad_asym, spatial_conv, spatial_simam, spatial_stripe_attention


def _token_dropout(x: torch.Tensor, rate: float, rng: DropoutRng | None,
                   mesh: Mesh) -> torch.Tensor:
    """Inverted dropout of a (B, L_local, C) token slab: the keep mask of
    the global (B, L_local * n, C) tokens, this rank's rows of it."""
    if rng is None or rate <= 0.0:
        return x
    B, L, C = x.shape
    keep = keep_mask((B, L * mesh.size, C), rate, rng.generator, x.device)
    return fast_dropout(x, rate, keep=keep[:, mesh.rank * L:(mesh.rank + 1) * L])


def _drop_path(x: torch.Tensor, rate: float, rng: DropoutRng | None) -> torch.Tensor:
    return x if rng is None else drop_path(x, rate, rng.generator)


def _attention(branch, q, k, v, mesh: Mesh, rng: DropoutRng | None):
    """One ``LePEAttention`` branch on the slab; its ``get_v`` bias after."""
    seed = None if rng is None else rng.next_seed()
    out = spatial_stripe_attention(
        q, k, v, branch.get_v.weight.permute(2, 3, 1, 0).to(q.dtype), H=branch.resolution,
        W=branch.resolution, hsp=branch.hsp, wsp=branch.wsp, num_heads=branch.num_heads,
        mesh=mesh, scale=branch.qk_scale, attn_drop=0.0 if rng is None else branch.attn_drop,
        seed=seed)
    return out + branch.get_v.bias.to(out.dtype)


def _cswin_block(blk, tokens: torch.Tensor, mesh: Mesh, rng: DropoutRng | None) -> torch.Tensor:
    """``models.layers.CSWinBlock`` on a token slab."""
    q, k, v = blk.qkv(blk.norm1(tokens)).chunk(3, dim=-1)
    if blk.last:
        a = _attention(blk.attns[0], q, k, v, mesh, rng)
    else:
        h = tokens.shape[-1] // 2
        a = torch.cat([_attention(blk.attns[0], q[..., :h], k[..., :h], v[..., :h], mesh, rng),
                       _attention(blk.attns[1], q[..., h:], k[..., h:], v[..., h:], mesh, rng)],
                      dim=-1)
    x = tokens + _drop_path(blk.proj(a), blk.drop_path, rng)
    mlp = blk.mlp
    m = _token_dropout(F.gelu(mlp.fc1(blk.norm2(x))), mlp.drop, rng, mesh)
    m = _token_dropout(mlp.fc2(m), mlp.drop, rng, mesh)
    return x + _drop_path(m, blk.drop_path, rng)


def _spatial_carafe(car, tokens: torch.Tensor, H: int, W: int, mesh: Mesh) -> torch.Tensor:
    """``models.layers.CARAFE`` on a token slab of an (H, W) grid: the 1x1
    compress, the 3x3 encoder with a 1-row halo, the out conv's linear part
    at low resolution halo'd 1 row each way (the kernel logits zero padded,
    not halo'd: those rows are cropped), the reassembly of the extended slab
    cropped by S rows a side, the bias after, then SimAM."""
    B, L, C = tokens.shape
    img = tokens.reshape(B, H // mesh.size, W, C)
    enc = spatial_conv(car.down(img), car.encoder.weight, car.encoder.bias, 1, 1, mesh)
    y = halo_pad_asym(car.out.linear(img), 1, 1, mesh)
    S = car.up_factor
    up = carafe_kernels.carafe_reassemble(y, F.pad(enc, (0, 0, 0, 0, 1, 1)), S)[:, S:-S]
    up = up + car.out.bias.to(up.dtype)
    if car.use_simam:
        up = spatial_simam(up, mesh)
    return nhwc_to_tokens(up)


def _cswin_forward(model, x: torch.Tensor, mesh: Mesh, rng: DropoutRng | None,
                   capture: dict | None) -> torch.Tensor:
    """``CSWinUNet.forward(..., use_kernels=False)`` op for op on one H-slab
    (NHWC in, NHWC logits out); ``capture`` collects each stage's tokens."""
    n, r = mesh.size, model.resos

    def snap(name, tokens):
        if capture is not None:
            capture[name] = tokens

    def run_stage(name, tokens):
        for blk in getattr(model, name):
            tokens = _cswin_block(blk, tokens, mesh, rng)
        snap(name, tokens)
        return tokens

    stem = model.stage1_conv_embed[0]
    img = spatial_conv(x.to(model.dtype), stem.weight, stem.bias, stem.stride, stem.padding,
                       mesh)
    if model.use_simam:
        img = spatial_simam(img, mesh)
    tokens = model.stage1_conv_embed[2](nhwc_to_tokens(img))
    tokens = _token_dropout(tokens, model.drop_rates[0], rng, mesh)
    snap("embed", tokens)
    B = tokens.shape[0]

    skips = []
    for s in range(4):
        tokens = run_stage(f"stage{s + 1}", tokens)
        if s < 3:
            skips.append(tokens)
            merge = getattr(model, f"merge{s + 1}")
            img = tokens.reshape(B, r[s] // n, r[s], tokens.shape[-1])
            img = spatial_conv(img, merge.conv.weight, merge.conv.bias, 2, 1, mesh)
            if merge.use_simam:
                img = spatial_simam(img, mesh)
            tokens = merge.norm(nhwc_to_tokens(img))
            snap(f"merge{s + 1}", tokens)
    tokens = run_stage("stage_up4", model.norm(tokens))
    for s in (2, 1, 0):
        tokens = _spatial_carafe(getattr(model, f"upsample{s + 2}"), tokens, r[s + 1],
                                 r[s + 1], mesh)
        snap(f"upsample{s + 2}", tokens)
        tokens = getattr(model, f"concat_linear{s + 2}")(torch.cat([skips[s], tokens], -1))
        tokens = run_stage(f"stage_up{s + 1}", tokens)
    tokens = _spatial_carafe(model.upsample1, model.norm_up(tokens), r[0], r[0], mesh)
    snap("upsample1", tokens)
    img = tokens.reshape(B, model.img_size // n, model.img_size, tokens.shape[-1])
    return model.output.image(img)


def validate_spatial_cswin(img_size: int, n_shards: int, split_size: Sequence[int]) -> None:
    """Every stage's resolution must split evenly over the ranks, and each
    stage but the last's horizontal stripe height must divide its slab
    (vertical stripes and the global window are gathered: no constraint)."""
    for s in range(4):
        reso = img_size // (4 * 2 ** s)
        if reso % n_shards:
            raise ValueError(
                f"stage {s + 1} resolution {reso} not divisible by "
                f"n_shards={n_shards} (img_size {img_size})")
        if s < 3 and (reso // n_shards) % split_size[s]:
            raise ValueError(
                f"stage {s + 1} local slab {reso // n_shards} rows not "
                f"divisible by horizontal stripe height {split_size[s]}; "
                f"reduce the spatial axis or change split_size")


def spatial_cswin_apply(model, x: torch.Tensor, mesh: Mesh, train: bool = False,
                        seed: int | None = None, capture_stages: bool = False):
    """The CSWin-UNet's forward with H sharded over ``mesh``: ``x`` is this
    rank's H-slab (B, img/n, img, in_chans) of the images, the result its
    slab of the logits (B, img/n, img, classes) in the model's dtype.

    ``train=False``: equal to ``model.forward(x, use_kernels=False)`` on the
    whole images, apart from float rounding.  ``train=True`` needs ``seed``
    (an integer, as JAX needs ``dropout_rng``) and applies the model's
    dropout, attention dropout and drop-path with masks keyed on global
    positions: any N-rank run equals the 1-rank run of this function, which
    drops what ``model.forward(x, train=True, rng=seed)`` drops.
    ``capture_stages=True`` also returns a dict of this rank's token slabs
    (B, L_local, C) after the embedding, each stage, merge and upsample
    (``embed``, ``stage1``-``stage4``, ``merge1``-``merge3``,
    ``upsample1``-``upsample4``, ``stage_up1``-``stage_up4``).  CUDA
    tensors run K-A / K-A' and K-C / K-C', CPU tensors their plain
    versions."""
    n = mesh.size
    validate_spatial_cswin(model.img_size, n, model.split_size)
    if getattr(model, "tp_shardings", None):
        raise ValueError("a model split over a 'model' axis (parallel.shard_state with "
                         "params_shardings) runs through its own forward, not H-sharded")
    if tuple(x.shape[1:3]) != (model.img_size // n, model.img_size):
        raise ValueError(f"rank {mesh.rank}'s slab must be {model.img_size // n} x "
                         f"{model.img_size}, got {tuple(x.shape[1:3])}")
    if train and seed is None:
        raise ValueError("train=True requires seed (an integer)")
    capture = {} if capture_stages else None
    out = _cswin_forward(model, x.to(model.device), mesh, model.dropout_rng(train, seed),
                         capture)
    return (out, capture) if capture_stages else out
