"""The dropout keep bits of the bf16 tensor-core attention bodies, their
indexing replayed on the CPU.

``csrc/flash_attention_mma.cuh`` computes the keep bit of score (query i,
key j) from the mma fragment's (row, column) directly.  A block holds 64
rows of one side (query rows in dq and in the forwards of K-A and the flash
family, ``csrc/attention_fwd_mma.cuh``; key rows in dk/dv), 16 a warp, lane
l = 4g + t holding rows g and g + 8; the other side streams in tiles of 64,
and per chunk of 16 a lane holds columns nt * 8 + 2t + c (nt, c in {0, 1}).
Per streamed tile the body either hoists the hash base and the counter
base out of the elements ("fast": the tile's valid indices lie in one mask
tile) or divides per element ("slow").  This file replays both paths in
numpy's wrapping uint32 arithmetic, for the query-fixed orientation (dq and
the forwards: key streamed) and dk/dv (key fixed, query streamed), and holds
every bit against the plain mask, ``ops/dropout.py::hash_bits``, in window
mode (mask tile N), in K-A and K-A' (the whole-window mask, mask tile N,
which ``window_keep_mask`` builds for the plain versions) and in flash mode
(mask tile ``pick_tile(N)``).  Last, the plain log-sum-exp of the tiled K-A's
windows against the plain flash forward's, which computes the same L.
"""

import numpy as np
import pytest
import torch

from cswin_simam_unet_tpu_torch.ops import attention, dropout
from cswin_simam_unet_tpu_torch.ops.flash_attention import flash_attention_reference, pick_tile

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


@pytest.mark.parametrize("N", [128, 196, 256, 384])
def test_forward_keep_bits_match_whole_window_mask(N):
    """K-A's tensor-core body: query fixed, the whole window's keys streamed
    in tiles of 64 against one N x N mask tile (counter i * N + j), every
    tile on the fast path; the bits are those of ``window_keep_mask``, the
    plain K-A's mask, for window 5 and head 1."""
    threshold = dropout.u32_threshold(0.3)
    win, head = 5, 1
    got, n_fast = _body_keep(win, head, N, N, threshold, query_fixed=True)
    want = dropout.window_keep_mask(SEED, win + 1, head + 1, N, threshold)[win, head].numpy()
    assert np.array_equal(got, want)
    assert n_fast == -(-N // ROWS) * -(-N // TILE)


@pytest.mark.parametrize("query_fixed", [True, False], ids=["dq", "dkv"])
@pytest.mark.parametrize("N", [128, 196, 256, 384])
def test_backward_keep_bits_match_whole_window_mask(N, query_fixed):
    """The tensor-core bodies of K-A', the tiled K-A' dq and dk/dv launched at
    the whole-window mask (mask tile N): query fixed in dq, key fixed in
    dk/dv (counter i * N + j stepped by N per streamed query), every tile on
    the fast path; the bits are ``window_keep_mask``'s, the plain K-A'
    mask, for window 6 and head 2."""
    threshold = dropout.u32_threshold(0.3)
    win, head = 6, 2
    got, n_fast = _body_keep(win, head, N, N, threshold, query_fixed)
    want = dropout.window_keep_mask(SEED, win + 1, head + 1, N, threshold)[win, head].numpy()
    assert np.array_equal(got, want)
    assert n_fast == -(-N // ROWS) * -(-N // TILE)


@pytest.mark.parametrize("N,mode", [(196, "flash"), (384, "flash"), (520, "flash"),
                                    (4096, "flash"), (512, "window")])
def test_forward_keep_bits_query_fixed(N, mode):
    """The flash forward's tensor-core body in both modes: the query-fixed
    replay against ``hash_keep_mask`` over mask tiles of N (window mode) or
    ``pick_tile(N)`` (flash mode: 196 and 384 one tile, 520 tiles of 104
    that cut the 64-key tiles, 4096 tiles of 512)."""
    T = N if mode == "window" else pick_tile(N)
    threshold = dropout.u32_threshold(0.3)
    got, _ = _body_keep(3, 2, N, T, threshold, query_fixed=True)
    ar = torch.arange(N)
    want = dropout.hash_keep_mask(SEED, torch.tensor(3), torch.tensor(2), ar[:, None],
                                  ar[None, :], threshold, T).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_lse_matches_flash_reference(dtype):
    """``attention.stripe_attention_lse``, the plain L of the tiled K-A, is
    the plain flash forward's L on full-width windows (bands): the same
    log-sum-exp of round(q * scale) . k."""
    rs = np.random.RandomState(3)
    B, H, W, hsp, heads, C = 2, 4, 14, 2, 2, 16
    q, k, v = (torch.from_numpy(rs.randn(B, H * W, C).astype(np.float32)).to(dtype)
               for _ in range(3))
    got = attention.stripe_attention_lse(q, k, H=H, W=W, hsp=hsp, wsp=W, num_heads=heads)
    N = hsp * W
    _, want = flash_attention_reference(q.reshape(-1, N, C), k.reshape(-1, N, C),
                                        v.reshape(-1, N, C), heads=heads)
    assert got.shape == want.shape == (B * H // hsp, N, heads) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
