"""Serving: uint8 NHWC images in, probabilities out.

Counterpart of ``cswin_simam_unet_tpu/serving.py``.  ``make_serving_fn``
is the deployment computation (divide by 255, ``predict``).  ``Server``
answers a request of any batch size the way the JAX package's bundled
artifact does: each chunk of at most the largest bucket runs at the
smallest bucket that holds it, zero-padded, and the padding is sliced off.
The JAX package's exported StableHLO artifacts have no counterpart here:
the server runs the model in process.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

BATCH_SIZES = (1, 2, 4, 8)


def make_serving_fn(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """uint8 (B, H, W, C) images -> probabilities (B, H, W, classes)."""

    def serve(images_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = images_u8.to(model.device).float() / 255.0
            return model.predict(x)

    return serve


class Server:
    """Answers requests of any batch size at the fixed ``batch_sizes``."""

    def __init__(self, model, batch_sizes: Sequence[int] = BATCH_SIZES):
        sizes = tuple(sorted({int(b) for b in batch_sizes}))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
        self.batch_sizes = sizes
        self.device = model.device
        self._serve = make_serving_fn(model)

    def bucket(self, n: int) -> int:
        """The batch size a chunk of ``n`` images runs at."""
        return next(s for s in self.batch_sizes if s >= n)

    def _run_padded(self, chunk: torch.Tensor) -> torch.Tensor:
        n = chunk.shape[0]
        b = self.bucket(n)
        if n < b:
            pad = torch.zeros((b - n,) + tuple(chunk.shape[1:]), dtype=torch.uint8,
                              device=chunk.device)
            chunk = torch.cat([chunk, pad], dim=0)
        return self._serve(chunk)[:n]

    def __call__(self, images) -> torch.Tensor:
        images = _coerce_uint8(images)
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = images.to(self.device)
        n = images.shape[0]
        max_b = self.batch_sizes[-1]
        if n <= max_b:
            return self._run_padded(images)
        return torch.cat([self._run_padded(images[i:i + max_b])
                          for i in range(0, n, max_b)], dim=0)


def _coerce_uint8(images):
    """uint8 as is; floats in [0, 1] are taken as normalised and scaled by
    255; other floats must be integer-valued 0-255 pixels, else ValueError;
    other dtypes are cast.  A float image whose 0-255 pixels all happen to be
    0 or 1 is read as normalised: pass uint8 to state intent.  A torch tensor
    must already be uint8 (TypeError otherwise); the rules above are for
    numpy arrays and array-likes."""
    if isinstance(images, torch.Tensor):
        if images.dtype != torch.uint8:
            raise TypeError(f"Server: a torch tensor request must be uint8, got {images.dtype}")
        return images
    arr = np.asarray(images)
    if arr.dtype == np.uint8:
        return arr
    if np.issubdtype(arr.dtype, np.floating):
        if arr.size == 0:
            return arr.astype(np.uint8)
        mn, mx = float(arr.min()), float(arr.max())
        if 0.0 <= mn and mx <= 1.0:
            return np.round(arr * 255.0).astype(np.uint8)
        if 0.0 <= mn and mx <= 255.0 and np.array_equal(arr, np.round(arr)):
            return arr.astype(np.uint8)
        raise ValueError(
            "Server: float input is neither normalised [0,1] nor "
            f"integer-valued 0-255 pixels (range [{mn:g}, {mx:g}]); pass uint8")
    return arr.astype(np.uint8)
