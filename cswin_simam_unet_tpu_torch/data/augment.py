"""Paired image/mask augmentation on the device.

Counterpart of ``cswin_simam_unet_tpu/data/augment.py``: the reference's
``AugmentationTransform`` per sample, vectorised over the batch,

* horizontal flip p=0.5 and vertical flip p=0.5 (independent draws);
* with p=0.25, a rotation by an angle uniform over {0, 90, 180, 270}
  degrees (each non-zero rotation 3/16 in all);
* always a random crop of scale ~ U(0.75, 1.0) (the floor taken for each
  side), at a uniform position, resized back bilinearly to the full size.

Image and mask take the same transform; masks go through the bilinear path
(soft at the edges, as the reference's) unless ``mask_nearest``, which
class-id masks need.

The whole flip -> rot90 -> crop -> resize chain is one separable resample
per sample, ``out = Rr @ X @ Rc^T`` (transposed for odd rotations): flips
and rotations fold into the interpolation matrices, whose bilinear rows are
the hat function ``max(0, 1 - |coord - index|)``.  The two products run in
full float32 (no TF32, whatever the process's setting), as JAX's run at
``Precision.HIGHEST``.

``jax.random`` is not reproduced, so the draws and the transform are two
functions: :func:`draw_params` makes the six per-sample draws from a
``torch.Generator``, :func:`augment_from_params` applies given draws, and
:func:`augment_batch` is the two together.  The gather form
(:func:`augment_gather`, per sample: flips, ``rot90``, ``crop_resize``) is
the plain oracle that the matrix form is held against.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from ..ops.image import crop_resize, rot90_batch_select


@dataclass(frozen=True)
class AugmentConfig:
    flip_prob: float = 0.5
    rotate_prob: float = 0.25
    crop_scale: tuple = (0.75, 1.0)
    # nearest-neighbour crop-resize of the mask: class-id masks need it;
    # False keeps the reference's soft bilinear masks of the binary head
    mask_nearest: bool = False


def draw_params(generator: torch.Generator, B: int, cfg: AugmentConfig = AugmentConfig()):
    """The six per-sample draws of JAX's ``_draw_params``, with the same
    distributions, in this order from ``generator`` (on the batch's device):
    hflip, vflip (bool), k (int64 in 0..3, 0 unless the rotation was
    drawn), scale ~ U(crop_scale), top_u, left_u ~ U(0, 1) (float32)."""
    dev = generator.device

    def uniform():
        return torch.rand(B, generator=generator, device=dev)

    hflip = uniform() < cfg.flip_prob
    vflip = uniform() < cfg.flip_prob
    do_rot = uniform() < cfg.rotate_prob
    angle = torch.randint(0, 4, (B,), generator=generator, device=dev)
    k = torch.where(do_rot, angle, torch.zeros_like(angle))
    lo, hi = cfg.crop_scale
    scale = lo + (hi - lo) * uniform()
    top_u = uniform()
    left_u = uniform()
    return hflip, vflip, k, scale, top_u, left_u


def _crop_windows(H: int, W: int, scale, top_u, left_u):
    """Crop size and position of each sample, in float32 as JAX computes
    them, so that JAX's draws give JAX's crops: floor(H * scale) and
    floor(u * (H - new_h + 1))."""
    scale, top_u, left_u = scale.float(), top_u.float(), left_u.float()
    new_h = torch.floor(H * scale)
    new_w = torch.floor(W * scale)
    top = torch.floor(top_u * (H - new_h + 1.0))
    left = torch.floor(left_u * (W - new_w + 1.0))
    return top, left, new_h, new_w


def _batched_axis_coords(out_size: int, crop_start, crop_size, limit: int) -> torch.Tensor:
    """(B,) crop starts and sizes -> (B, out_size) float32 source coords,
    the cv2 half-pixel rule clamped to the window and then to the image."""
    d = torch.arange(out_size, dtype=torch.float32, device=crop_size.device)[None, :]
    cs = crop_size.float()[:, None]
    src = (d + 0.5) * (cs / out_size) - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0), cs - 1.0)
    src = src + crop_start.float()[:, None]
    return torch.clamp(src, 0.0, float(limit - 1))


def _interp_matrix(coords: torch.Tensor, N: int, nearest: bool = False) -> torch.Tensor:
    """(B, O) clamped coords -> (B, O, N) interpolation matrix: the hat
    function (bilinear, two taps 1-w and w), or one-hot at round(coord)
    (nearest, half to even)."""
    grid = torch.arange(N, dtype=torch.float32, device=coords.device)
    if nearest:
        return (torch.round(coords)[..., None] == grid).float()
    return torch.clamp(1.0 - (coords[..., None] - grid).abs(), min=0.0)


@contextlib.contextmanager
def _full_float32():
    """Matrix products in full float32 inside: TF32 would round the image
    through a 10-bit mantissa (about 1e-3 on [0, 1] data)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _resample(x: torch.Tensor, Rr: torch.Tensor, Rc: torch.Tensor,
              swap: torch.Tensor) -> torch.Tensor:
    """out[b] = Rr[b] @ x[b] @ Rc[b]^T over (H, W) of x (B, H, W, C),
    transposed where ``swap``.  The second product leaves the result
    transposed, (B, P, O, C); it is put back where ``swap`` is false."""
    B, H, W, C = x.shape
    O, P = Rr.shape[1], Rc.shape[1]
    with _full_float32():
        t = torch.bmm(Rr, x.reshape(B, H, W * C)).reshape(B, O, W, C)
        t = t.permute(0, 2, 1, 3).reshape(B, W, O * C)
        s_t = torch.bmm(Rc, t).reshape(B, P, O, C)
    return torch.where(swap[:, None, None, None], s_t, s_t.transpose(1, 2))


def _coord_transforms(hflip, vflip, k, ys, xs, N: int):
    """Fold flip^hf, vf, then rot90^k (CCW), then the crop's sampling into
    per-axis source coordinates of the original image:

      k=0: rows from ys,      cols from xs       (no output transpose)
      k=1: rows from xs,      cols from N-1-ys   (output transposed)
      k=2: rows from N-1-ys,  cols from N-1-xs
      k=3: rows from N-1-xs,  cols from ys       (output transposed)

    then vflip reverses the row coords and hflip the column coords."""
    N1 = float(N - 1)
    kk = k[:, None]
    r = torch.where(kk == 0, ys, torch.where(kk == 1, xs, torch.where(kk == 2, N1 - ys, N1 - xs)))
    c = torch.where(kk == 0, xs, torch.where(kk == 1, N1 - ys, torch.where(kk == 2, N1 - xs, ys)))
    r = torch.where(vflip[:, None], N1 - r, r)
    c = torch.where(hflip[:, None], N1 - c, c)
    return r, c, (k % 2) == 1


def augment_from_params(images: torch.Tensor, masks: torch.Tensor, hflip, vflip, k, scale,
                        top_u, left_u, cfg: AugmentConfig = AugmentConfig()):
    """Apply the given draws: images (B, H, W, C) and masks (B, H, W, 1),
    float, square -> the augmented pair, float32, same shapes.  Float64
    inputs give a float64 result from the same float32 coordinates: the
    reference that the float32 products are held against."""
    B, H, W = images.shape[0], images.shape[1], images.shape[2]
    if H != W:
        raise ValueError(f"augmentation requires square images for the rot90 family, "
                         f"got {H}x{W}")
    dt = torch.float64 if images.dtype == torch.float64 else torch.float32
    images, masks = images.to(dt), masks.to(dt)
    top, left, new_h, new_w = _crop_windows(H, W, scale, top_u, left_u)
    ys = _batched_axis_coords(H, top, new_h, H)
    xs = _batched_axis_coords(W, left, new_w, W)
    r, c, swap = _coord_transforms(hflip, vflip, k, ys, xs, H)
    Rr, Rc = _interp_matrix(r, H).to(dt), _interp_matrix(c, W).to(dt)
    if cfg.mask_nearest:
        return (_resample(images, Rr, Rc, swap),
                _resample(masks, _interp_matrix(r, H, True).to(dt),
                          _interp_matrix(c, W, True).to(dt), swap))
    out = _resample(torch.cat([images, masks], dim=-1), Rr, Rc, swap)
    return out[..., :-1], out[..., -1:]


def augment_batch(generator: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                  cfg: AugmentConfig = AugmentConfig()):
    """Augment a batch on its device: :func:`draw_params` from
    ``generator``, then :func:`augment_from_params`."""
    return augment_from_params(images, masks, *draw_params(generator, images.shape[0], cfg),
                               cfg=cfg)


def augment_one(image, mask, hflip, vflip, k, scale, top_u, left_u,
                cfg: AugmentConfig = AugmentConfig()):
    """One sample's augmentation by gathers (JAX's ``_augment_one``):
    image (H, W, C), mask (H, W, 1), the draws as 0-d tensors."""
    H, W = image.shape[0], image.shape[1]
    pair = torch.cat([image.float(), mask.float()], dim=-1)
    if bool(hflip):
        pair = pair.flip(1)
    if bool(vflip):
        pair = pair.flip(0)
    pair = rot90_batch_select(pair, k)
    top, left, new_h, new_w = (t[0] for t in _crop_windows(
        H, W, scale.reshape(1), top_u.reshape(1), left_u.reshape(1)))
    if cfg.mask_nearest:
        return (crop_resize(pair[..., :-1], top, left, new_h, new_w, H, W),
                crop_resize(pair[..., -1:], top, left, new_h, new_w, H, W, method="nearest"))
    pair = crop_resize(pair, top, left, new_h, new_w, H, W)
    return pair[..., :-1], pair[..., -1:]


def augment_gather(images, masks, hflip, vflip, k, scale, top_u, left_u,
                   cfg: AugmentConfig = AugmentConfig()):
    """The gather form over a batch (JAX's ``_augment_batch_gather`` with
    given draws): the plain oracle of :func:`augment_from_params`."""
    outs = [augment_one(images[b], masks[b], hflip[b], vflip[b], k[b], scale[b], top_u[b],
                        left_u[b], cfg) for b in range(images.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
