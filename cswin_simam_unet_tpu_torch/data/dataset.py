"""Paired image/mask files, and the train/test split.

Counterpart of ``cswin_simam_unet_tpu/data/dataset.py``, with the
reference's ``SegmentationDataset`` semantics: the sorted ``*.jpg`` files of
the image directory; each mask by the same basename in the mask directory; a
missing or undecodable mask becomes a zero mask with a warning; the bytes are
read and decoded in memory; BGR becomes RGB; image and mask are both resized
bilinearly to the target size (the mask soft at the edges, as the
reference's), or the mask by nearest neighbour for class ids.  An image
directory without a ``.jpg`` raises.

The host stops at decoded and resized uint8; scaling and augmentation run on
the device (``data/augment.py``).  Decoders, in JAX's order: the native
library (bilinear only, so nearest skips it), then cv2, then PIL.
``DECODES`` counts the files each decoder read (the native batch path under
``native_batch``), so a run can say which ran; no value depends on it.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import warnings
from glob import glob
from typing import Optional, Sequence, Tuple

import numpy as np

from . import native_loader

BACKENDS = ("native", "cv2", "pil")  # tried in this order
DECODES: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()


def _count(backend: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        DECODES[backend] += n


def _decode_resize_cv2(data: bytes, size: Tuple[int, int], gray: bool, nearest: bool = False):
    import cv2
    img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8),
                       cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    if img is None:
        return None
    if not gray:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    # cv2.resize takes (width, height); size is (height, width)
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.resize(img, (size[1], size[0]), interpolation=interp)


def _decode_resize_pil(data: bytes, size: Tuple[int, int], gray: bool, nearest: bool = False):
    import io
    from PIL import Image
    img = Image.open(io.BytesIO(data)).convert("L" if gray else "RGB")
    img = img.resize((size[1], size[0]), Image.NEAREST if nearest else Image.BILINEAR)
    return np.asarray(img)


def decoders() -> dict:
    """Which decoders this machine has: {'native': bool, 'cv2': bool,
    'pil': bool, 'native_status': what loading the native library gave}."""
    found = {"native": native_loader.available(), "native_status": native_loader.STATUS}
    for name, module in (("cv2", "cv2"), ("pil", "PIL.Image")):
        try:
            __import__(module)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def decode_resize(data: bytes, size: Tuple[int, int], gray: bool = False,
                  nearest: bool = False) -> Optional[np.ndarray]:
    """Decode an encoded image and resize it to (H, W): uint8 HWC (RGB) or
    HW (gray), or None if undecodable.  ``nearest`` resamples by nearest
    neighbour (class-id masks) and skips the bilinear-only native library."""
    tried = False
    for backend in BACKENDS:
        if backend == "native":
            if nearest or not native_loader.available():
                continue
            tried = True
            out = native_loader.decode_resize(data, size, gray)
            if out is not None:
                _count("native")
                return out
            continue
        try:
            fn = _decode_resize_cv2 if backend == "cv2" else _decode_resize_pil
            out = fn(data, size, gray, nearest)
        except ImportError:
            continue
        tried = True
        # cv2 returns None for bytes it cannot decode, as JAX's path does;
        # PIL raises
        if out is not None:
            _count(backend)
        return out
    if not tried:
        raise ImportError(f"no image decoder among {BACKENDS}: the native library "
                          f"({native_loader.STATUS}), cv2 and PIL are all missing")
    return None


class SegmentationDataSource:
    """Indexable source of (image uint8 HWC, mask uint8 HW1) pairs."""

    IMAGE_EXTS = ("*.jpg",)  # the reference globs *.jpg only

    def __init__(self, image_dir: str, mask_dir: str,
                 image_size: Tuple[int, int] = (448, 448),
                 extensions: Sequence[str] = IMAGE_EXTS, mask_nearest: bool = False):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.image_size = tuple(image_size)
        self.mask_nearest = mask_nearest
        paths = []
        for ext in extensions:
            paths.extend(glob(os.path.join(image_dir, ext)))
        self.image_paths = sorted(paths)
        if not self.image_paths:
            raise ValueError(f"no images found in directory: {image_dir}")

    def __len__(self) -> int:
        return len(self.image_paths)

    def mask_path(self, idx: int) -> Optional[str]:
        path = os.path.join(self.mask_dir, os.path.basename(self.image_paths[idx]))
        return path if os.path.exists(path) else None

    def load_batch(self, indices) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The native threaded batch load, straight into the batch's
        buffers; None where the library is missing or not first among
        ``BACKENDS``, the masks are nearest, or a file needs another
        decoder (the caller then loads sample by sample)."""
        if BACKENDS[0] != "native" or self.mask_nearest or not native_loader.available():
            return None
        img_paths = [self.image_paths[i] for i in indices]
        mask_paths = [self.mask_path(i) for i in indices]
        out = native_loader.load_batch(img_paths, mask_paths, self.image_size)
        if out is None:
            return None
        images, masks, status = out
        if np.any(status == 1):  # an undecodable image: per sample
            return None
        bad_mask = status == 2
        # a mask file that exists but libjpeg cannot read (PNG bytes under a
        # .jpg name, say) goes to cv2/PIL, as the reference's imdecode reads
        # it; only a missing mask becomes the zero mask
        if any(bad_mask[i] and mask_paths[i] is not None for i in range(len(indices))):
            return None
        for i in np.nonzero(bad_mask)[0]:
            warnings.warn(f"no mask for {os.path.basename(img_paths[i])}; using empty mask")
        _count("native_batch", 2 * len(indices) - int(bad_mask.sum()))
        return images, masks

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        img_path = self.image_paths[idx]
        with open(img_path, "rb") as f:
            image = decode_resize(f.read(), self.image_size, gray=False)
        if image is None:
            raise ValueError(f"cannot decode image: {img_path}")
        name = os.path.basename(img_path)
        mask_path = os.path.join(self.mask_dir, name)
        mask = None
        if os.path.exists(mask_path):
            with open(mask_path, "rb") as f:
                mask = decode_resize(f.read(), self.image_size, gray=True,
                                     nearest=self.mask_nearest)
            if mask is None:
                warnings.warn(f"cannot decode mask for {name}; using empty mask")
        else:
            warnings.warn(f"no mask found for {name}; using empty mask")
        if mask is None:
            mask = np.zeros(self.image_size, dtype=np.uint8)
        return image, mask[..., None]


def train_test_indices(n: int, test_split: float = 0.2,
                       seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's ``train_test_split(range(n), test_size, random_state)``
    without sklearn: the permutation of ``RandomState(seed)``, its first
    ceil(test_split * n) indices the test side, the rest the training side
    (sklearn's ShuffleSplit draws exactly this)."""
    n_test = int(math.ceil(test_split * n))
    if not 0 < n_test < n:
        raise ValueError(f"test_split {test_split} of {n} samples leaves a side empty")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]
