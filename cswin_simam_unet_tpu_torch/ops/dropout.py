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
  2^32 - 1).  The kernels compute the same hash element by element, so the
  forward, the backward and the plain version drop the same scores without
  storing a mask.  The mask is tiled as ``hash_keep_mask`` tiles it: one
  N x N tile per window for the whole-window attention (K-A, K-A' and the
  tiled kernels of such windows), tiles of ``_pick_tile(N)`` in band order
  for the flash path.  A window is keyed on its number in the whole image
  (:func:`mask_windows`), so that an H-slab of an image (the spatial
  sharding of ``parallel/spatial_cswin.py``) draws its windows' bits, and a
  head on its number in the whole layer (``head0`` + its index in the
  call), so that a rank's own heads (the tensor parallelism of
  ``parallel/sharding.py``) draw those heads' bits.
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
              col: torch.Tensor, tile: int) -> torch.Tensor:
    """The 32 hash bits (int64 in [0, 2^32)) of score (row, col) of ``head`` in
    global window ``window`` (b * windows per image + w) with mask tiles of
    edge ``tile``: ``pallas_attention_flash.hash_keep_mask`` of tile
    (row // tile, col // tile) at element (row % tile, col % tile).  With
    ``tile`` the window's token count this is tile (0, 0) of one (n, n) tile,
    the whole-window convention.  Integer tensors broadcast against each
    other."""
    row, col = row.long(), col.long()
    t = (window.long() * 1_000_003 + head.long()) & MASK32
    t = (t * 4099 + row // tile) & MASK32
    t = (t * 257 + col // tile) & MASK32
    base = _mul32(torch.full_like(t, seed & MASK32), _SEED_MUL) ^ _mul32(t, _TILE_MUL)
    return _fmix32(((row % tile) * tile + col % tile) ^ base)


def hash_keep_mask(seed: int, window: torch.Tensor, head: torch.Tensor, row: torch.Tensor,
                   col: torch.Tensor, threshold: int, tile: int) -> torch.Tensor:
    """Bool keep decisions: :func:`hash_bits` >= ``threshold``."""
    return hash_bits(seed, window, head, row, col, tile) >= threshold


def mask_windows(n_windows: int, nwin: int | None = None, win0: int = 0,
                 nwin_global: int | None = None, device=None) -> torch.Tensor:
    """The numbers the keep mask gives ``n_windows`` windows, numbered
    b * nwin + w in ``windows.img2windows`` order over ``nwin`` windows an
    image: window b * nwin_global + win0 + w of the whole image, as
    ``common.cuh::drop_window`` numbers them.  An H-slab holding windows
    [win0, win0 + nwin) of an image of ``nwin_global`` windows so draws the
    bits of those windows.  The defaults (win0 0, nwin_global = nwin) give
    0 .. n_windows - 1."""
    ids = torch.arange(n_windows, device=device)
    if win0 == 0 and nwin_global in (None, nwin):
        return ids
    if nwin is None or n_windows % nwin:
        raise ValueError(f"{n_windows} windows do not split into images of nwin={nwin}")
    return ids // nwin * nwin_global + win0 + ids % nwin


def window_keep_mask(seed: int, n_windows: int, heads: int, n: int, threshold: int,
                     device=None, *, nwin: int | None = None, win0: int = 0,
                     nwin_global: int | None = None, head0: int = 0) -> torch.Tensor:
    """The keep mask of every score of a partitioned branch, (n_windows,
    heads, n, n), windows numbered as ``windows.img2windows`` orders them
    (batch-major, then window rows, then window columns) and tokens
    row-major within a window.  ``nwin``, ``win0``, ``nwin_global``: the
    windows are windows [win0, win0 + nwin) of each image of
    ``nwin_global`` (:func:`mask_windows`), the rows of the mask of that
    whole image.  ``head0``: the heads are heads [head0, head0 + heads) of
    the layer, the columns of the mask of all its heads."""
    ar = lambda m: torch.arange(m, device=device)  # noqa: E731
    windows = mask_windows(n_windows, nwin, win0, nwin_global, device)
    return hash_keep_mask(seed, windows[:, None, None, None],
                          (head0 + ar(heads))[None, :, None, None], ar(n)[None, None, :, None],
                          ar(n)[None, None, None, :], threshold, n)


def kernel_drop_args(attn_drop: float, seed: int | None, win0: int = 0,
                     nwin_global: int | None = None,
                     head0: int = 0) -> tuple[int, int, float, int, int, int]:
    """(seed, u32 threshold, 1 / (1 - rate), win0, nwin_global, head0) of
    an attention call for the kernels; threshold 0 is no dropout,
    nwin_global 0 the launch's own window count (``common.cuh::attn_drop``)."""
    threshold = u32_threshold(attn_drop)
    if not threshold:
        return 0, 0, 1.0, 0, 0, 0
    if seed is None:
        raise ValueError("attention dropout needs a seed")
    return (int(seed) & MASK32, threshold, 1.0 / (1.0 - attn_drop), int(win0),
            int(nwin_global or 0), int(head0))


def keep_mask(shape, rate: float, generator: torch.Generator | None = None,
              device=None) -> torch.Tensor:
    """:func:`fast_dropout`'s keep mask of ``shape``: 16 uniform bits from
    ``generator`` >= u16_threshold(rate)."""
    # int16 bits b stand for the u16 value b + 2^15
    bits = torch.randint(-32768, 32768, tuple(shape), dtype=torch.int16, device=device,
                         generator=generator)
    return bits >= u16_threshold(rate) - 32768


def fast_dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None = None,
                 keep: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout: x * (1 / (1 - rate)) where kept, 0 elsewhere.  The
    keep mask is "16 uniform bits >= u16_threshold(rate)" drawn from
    ``generator`` (on x's device), or ``keep`` (bool, x's shape) when given.
    ``rate <= 0`` returns x."""
    if rate <= 0.0:
        return x
    if keep is None:
        keep = keep_mask(x.shape, rate, generator, x.device)
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

    def state(self) -> tuple:
        """Where the draws stand: the generator's state and the count of
        attention calls.  :meth:`restore` of it makes the calls that follow
        draw again what they drew after it was taken."""
        return self.generator.get_state(), self._calls

    def restore(self, state: tuple) -> None:
        self.generator.set_state(state[0])
        self._calls = state[1]
