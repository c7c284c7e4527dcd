"""Dropout, drop-path and the attention-dropout keep mask.

Counterpart of ``cswin_simam_unet_tpu/ops/dropout.py::fast_dropout``,
``models/layers.py::DropPath`` and the counter-hash keep mask of
``ops/pallas_attention_flash.py::hash_keep_mask``.

* :func:`fast_dropout`: inverted dropout whose keep test is "16 uniform bits
  >= min(round(rate * 2^16), 65535)" and whose rescale is the nominal
  1 / (1 - rate), in the dtype of x.  The bits come from an explicit
  ``torch.Generator`` on x's device.
* :func:`drop_path`: per-sample stochastic depth (timm semantics), x / keep
  for the kept samples, drawn from the same generator.
* :func:`hash_keep_mask`: the attention keep mask as a pure function of
  (seed, window, head, query token, key token): murmur3's fmix32 over a
  counter, compared against the u32 threshold min(round(rate * 2^32),
  2^32 - 1).  Kernels K-A and K-A' compute the same hash element by element,
  so the forward, the backward and the plain version drop the same scores
  without storing a mask.
* :class:`DropoutRng`: the randomness of one training forward, made from one
  host seed: the generator for the two above and a fresh 32-bit seed per
  attention call, derived on the host so that no step reads the device.

Torch has little ``uint32`` support on the CPU, so the hash computes in
``int64`` masked to 32 bits, splitting each 32 x 32-bit product so that no
intermediate overflows a signed 64-bit integer.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_SEED_MUL = 0x9E3779B9
_TILE_MUL = 0x85EBCA6B
_FMIX_1 = 0x85EBCA6B
_FMIX_2 = 0xC2B2AE35


def u16_threshold(rate: float) -> int:
    """Keep iff 16 uniform bits >= this: P(keep) = 1 - threshold / 2^16."""
    return min(int(round(rate * 65536.0)), 65535)


def u32_threshold(rate: float) -> int:
    """The attention mask's threshold (0 when ``rate <= 0``: keep all)."""
    if rate <= 0.0:
        return 0
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the JAX package's weakly typed
    scalars are before they meet a tensor of that dtype."""
    return float(torch.tensor(value, dtype=dtype))


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """a * b mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit constant b."""
    lo = a * (b & 0xFFFF)                            # < 2^48
    hi = ((a * (b >> 16)) & 0xFFFF) << 16            # < 2^32
    return (lo + hi) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x ^ (x >> 16), _FMIX_1)
    x = _mul32(x ^ (x >> 13), _FMIX_2)
    return x ^ (x >> 16)


def hash_bits(seed: int, window: torch.Tensor, head: torch.Tensor, row: torch.Tensor,
              col: torch.Tensor, n: int) -> torch.Tensor:
    """The 32 hash bits (int64 in [0, 2^32)) of score (row, col) of ``head`` in
    global window ``window`` (b * windows per image + w) for windows of ``n``
    tokens: ``pallas_attention_flash.hash_keep_mask`` at tile (0, 0) of a
    (n, n) tile.  Integer tensors broadcast against each other."""
    tile = ((window.long() * 1_000_003 + head.long()) & MASK32) * (4099 * 257) & MASK32
    base = _mul32(torch.full_like(tile, seed & MASK32), _SEED_MUL) ^ _mul32(tile, _TILE_MUL)
    return _fmix32((row.long() * n + col.long()) ^ base)


def hash_keep_mask(seed: int, window: torch.Tensor, head: torch.Tensor, row: torch.Tensor,
                   col: torch.Tensor, threshold: int, n: int) -> torch.Tensor:
    """Bool keep decisions: :func:`hash_bits` >= ``threshold``."""
    return hash_bits(seed, window, head, row, col, n) >= threshold


def window_keep_mask(seed: int, n_windows: int, heads: int, n: int, threshold: int,
                     device=None) -> torch.Tensor:
    """The keep mask of every score of a partitioned branch, (n_windows,
    heads, n, n), windows numbered as ``windows.img2windows`` orders them
    (batch-major, then window rows, then window columns) and tokens
    row-major within a window."""
    ar = lambda m: torch.arange(m, device=device)  # noqa: E731
    return hash_keep_mask(seed, ar(n_windows)[:, None, None, None],
                          ar(heads)[None, :, None, None], ar(n)[None, None, :, None],
                          ar(n)[None, None, None, :], threshold, n)


def fast_dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None = None,
                 keep: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout: x * (1 / (1 - rate)) where kept, 0 elsewhere.  The
    keep mask is "16 uniform bits >= u16_threshold(rate)" drawn from
    ``generator`` (on x's device), or ``keep`` (bool, x's shape) when given.
    ``rate <= 0`` returns x."""
    if rate <= 0.0:
        return x
    if keep is None:
        # int16 bits b stand for the u16 value b + 2^15
        bits = torch.randint(-32768, 32768, x.shape, dtype=torch.int16, device=x.device,
                             generator=generator)
        keep = bits >= u16_threshold(rate) - 32768
    scale = _in_dtype(1.0 / (1.0 - rate), x.dtype)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator | None = None,
              keep: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample stochastic depth: sample b of x is kept with probability
    1 - rate (``keep`` (B,) bool when given) and then divided by 1 - rate."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    if keep is None:
        keep = torch.rand(x.shape[0], device=x.device, generator=generator) < keep_prob
    keep = keep.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(keep, x / _in_dtype(keep_prob, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def mix_seed(seed: int, counter: int) -> int:
    """A 32-bit seed from (seed, counter): splitmix64's finaliser over both."""
    z = (seed * 0x9E3779B97F4A7C15 + (counter + 1) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) & MASK32


class DropoutRng:
    """The randomness of one training forward, all from the host seed
    ``seed``: ``generator`` (on ``device``) draws the dropout and drop-path
    masks in call order, and :meth:`next_seed` gives each attention call its
    own 32-bit hash seed.  Two forwards that make the same calls from the same
    seed drop the same elements."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(self.seed)
        self._calls = 0

    def next_seed(self) -> int:
        self._calls += 1
        return mix_seed(self.seed, self._calls)
