"""Image ops on the device: bilinear and nearest resize and crop-resize in
cv2's conventions, and rot90 by a per-call k.

Counterpart of ``cswin_simam_unet_tpu/ops/image.py``.  Images are HWC
tensors on any device.  ``resize_bilinear`` samples as ``cv2.resize``
(INTER_LINEAR) does: half-pixel centres, ``src = (dst + 0.5) * scale - 0.5``,
clamped to the image; ``crop_resize`` samples a crop window the same way, so
a random crop resized back to the full size needs no shape that depends on
the data.  The nearest path rounds half to even (``torch.round``, as
``jnp.round``).  These are the plain versions that the augmentation's
matrix form (``data/augment.py``) is held against.
"""

from __future__ import annotations

import torch


def _axis_coords(out_size: int, crop_start, crop_size, limit: int,
                 device=None) -> torch.Tensor:
    """Float32 source coordinates of one axis: the cv2 half-pixel rule over
    the crop window, clamped to the window and then to [0, limit - 1]."""
    crop_start = torch.as_tensor(crop_start, device=device).float()
    crop_size = torch.as_tensor(crop_size, device=device).float()
    d = torch.arange(out_size, dtype=torch.float32, device=crop_size.device)
    src = (d + 0.5) * (crop_size / out_size) - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0), crop_size - 1.0)
    return torch.clamp(src + crop_start, 0.0, float(limit - 1))


def sample_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample the HWC image at the outer product of float coords ys x xs."""
    H, W = img.shape[0], img.shape[1]
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (ys - y0.float())[:, None, None]
    wx = (xs - x0.float())[None, :, None]
    rows0, rows1 = img[y0], img[y1]
    v00, v01 = rows0[:, x0], rows0[:, x1]
    v10, v11 = rows1[:, x0], rows1[:, x1]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``cv2.resize(INTER_LINEAR)`` of an HWC image, in float32."""
    H, W = img.shape[0], img.shape[1]
    ys = _axis_coords(out_h, 0, H, H, img.device)
    xs = _axis_coords(out_w, 0, W, W, img.device)
    return sample_bilinear(img.float(), ys, xs)


def sample_nearest(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample at float coords ys x xs, rounding half to
    even: for class-id masks, where interpolating would invent classes."""
    return img[torch.round(ys).long()][:, torch.round(xs).long()]


def crop_resize(img: torch.Tensor, top, left, crop_h, crop_w, out_h: int, out_w: int,
                method: str = "bilinear") -> torch.Tensor:
    """Crop ``[top:top+crop_h, left:left+crop_w]`` and resize it to
    (out_h, out_w); ``method='nearest'`` keeps class ids."""
    H, W = img.shape[0], img.shape[1]
    ys = _axis_coords(out_h, top, crop_h, H, img.device)
    xs = _axis_coords(out_w, left, crop_w, W, img.device)
    if method == "nearest":
        return sample_nearest(img, ys, xs)
    return sample_bilinear(img.float(), ys, xs)


def rot90_batch_select(img: torch.Tensor, k) -> torch.Tensor:
    """Rotate a square HWC image by k x 90 degrees counter-clockwise (as
    ``jnp.rot90`` / ``numpy.rot90`` over the first two axes)."""
    return torch.rot90(img, int(k) % 4, dims=(0, 1))
