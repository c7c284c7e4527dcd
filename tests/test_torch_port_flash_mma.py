"""The dropout keep bits of the flash family's bf16 tensor-core backward
bodies, their indexing replayed on the CPU.

``csrc/flash_attention_mma.cuh`` computes the keep bit of score (query i,
key j) from the mma fragment's (row, column) directly.  A block holds 64
rows of one side (query rows in dq, key rows in dk/dv), 16 a warp, lane
l = 4g + t holding rows g and g + 8; the other side streams in tiles of 64,
and per chunk of 16 a lane holds columns nt * 8 + 2t + c (nt, c in {0, 1}).
Per streamed tile the body either hoists the hash base and the counter
base out of the elements ("fast": the tile's valid indices lie in one mask
tile) or divides per element ("slow").  This file replays both paths in
numpy's wrapping uint32 arithmetic, for dq (query fixed, key streamed) and
dk/dv (key fixed, query streamed), and holds every bit against the plain
mask, ``ops/dropout.py::hash_bits``, in window mode (mask tile N) and flash
mode (mask tile ``pick_tile(N)``).
"""

import numpy as np
import pytest
import torch

from cswin_simam_unet_tpu_torch.ops import dropout
from cswin_simam_unet_tpu_torch.ops.flash_attention import pick_tile

ROWS = TILE = 64   # mma::kRows, mma::kTile
SEED = 2 ** 31 + 12345
U32 = np.uint32


def _u32(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, dtype=np.int64)).astype(U32)


def _fmix_keep(x: np.ndarray, threshold: int) -> np.ndarray:
    """common.cuh::drop_keep after the counter ^ base."""
    x = (x ^ (x >> U32(16))) * U32(0x85EBCA6B)
    x = (x ^ (x >> U32(13))) * U32(0xC2B2AE35)
    return (x ^ (x >> U32(16))) >= U32(threshold)


def _lane_layout() -> tuple[np.ndarray, np.ndarray]:
    """(fixed row within the block, streamed offset within the tile) of every
    element a block's lanes hold: warp w, lane 4g + t, row g + 8r; chunk kc,
    n-tile nt, column 2t + c."""
    w, g, t, r, kc, nt, c = np.meshgrid(*(np.arange(n) for n in (4, 8, 4, 2, 4, 2, 2)),
                                        indexing="ij")
    return (16 * w + g + 8 * r).ravel(), (16 * kc + 8 * nt + 2 * t + c).ravel()


def _body_keep(win: int, head: int, N: int, T: int, threshold: int, query_fixed: bool):
    """The keep bits as the body computes them, [query, key], and how many
    streamed tiles took the fast path."""
    fixed_local, stream_local = _lane_layout()
    mix = _u32(SEED) * U32(0x9E3779B9)
    wh = _u32(win) * U32(1000003) + _u32(head)
    Tu = U32(T)
    keep = np.zeros((N, N), bool)
    n_fast = 0
    for f0 in range(0, N, ROWS):
        f = f0 + fixed_local
        f_tile, f_off = _u32(f // T), _u32(f % T)
        for s0 in range(0, N, TILE):
            so, st = s0 % T, s0 // T
            fast = so + min(TILE, N - s0) <= T
            n_fast += fast
            local = _u32(stream_local)
            if fast:  # keep_hoist: one base and counter base per fixed row
                if query_fixed:
                    base = mix ^ (((wh * U32(4099) + f_tile) * U32(257) + _u32(st))
                                  * U32(0x85EBCA6B))
                    x = (f_off * Tu + _u32(so) + local) ^ base
                else:
                    base = mix ^ (((wh * U32(4099) + _u32(st)) * U32(257) + f_tile)
                                  * U32(0x85EBCA6B))
                    x = (_u32(so) * Tu + f_off + local * Tu) ^ base
            else:  # keep_slow: the streamed index's tile and offset per element
                s = s0 + stream_local
                s_tile, s_off = _u32(s // T), _u32(s % T)
                if query_fixed:
                    base = mix ^ (((wh * U32(4099) + f_tile) * U32(257) + s_tile)
                                  * U32(0x85EBCA6B))
                    x = (f_off * Tu + s_off) ^ base
                else:
                    base = mix ^ (((wh * U32(4099) + s_tile) * U32(257) + f_tile)
                                  * U32(0x85EBCA6B))
                    x = (s_off * Tu + f_off) ^ base
            bits = _fmix_keep(x, threshold)
            s = s0 + stream_local
            ok = (f < N) & (s < N)
            i, j = (f[ok], s[ok]) if query_fixed else (s[ok], f[ok])
            keep[i, j] = bits[ok]
    return keep, n_fast


def test_lane_layout_covers_each_element_once():
    rows, cols = _lane_layout()
    pairs = rows * TILE + cols
    assert np.array_equal(np.sort(pairs), np.arange(ROWS * TILE))


@pytest.mark.parametrize("query_fixed", [True, False], ids=["dq", "dkv"])
@pytest.mark.parametrize("N,mode", [(400, "window"), (448, "window"), (1024, "window"),
                                    (520, "flash"), (1024, "flash"), (40, "flash")])
def test_body_keep_bits_match_hash_keep_mask(N, mode, query_fixed):
    T = N if mode == "window" else pick_tile(N)
    threshold = dropout.u32_threshold(0.3)
    win, head = 7, 3
    got, n_fast = _body_keep(win, head, N, T, threshold, query_fixed)
    ar = torch.arange(N)
    want = dropout.hash_keep_mask(SEED, torch.tensor(win), torch.tensor(head), ar[:, None],
                                  ar[None, :], threshold, T).numpy()
    assert np.array_equal(got, want)
    n_tiles = -(-N // ROWS) * -(-N // TILE)
    if T < N and T % TILE:  # mask tiles (104 of 520) that cut the 64-row tiles
        assert 0 < n_fast < n_tiles
    else:  # one mask tile per window, or mask tiles of whole 64-row tiles
        assert n_fast == n_tiles
