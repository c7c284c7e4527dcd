"""PyTorch port, kernel K5 (the standalone SimAM head's dx/db pass) on the CPU.

(a) The plain K5, ``carafe_head.head_bwd2_reference``, against the JAX
package's own kernel bodies, ``pallas_simam_head._bwd2_kernel`` and
``_bwd2_nogate_kernel``, called directly on numpy buffers as their refs: a
whole small image as the row tile, a zero bias, ``kwt`` from ``_kron_eye``,
the statistics and the pooled A, B tiled over the G slots as
``simam_head``'s backward passes them.  float32, tolerance 2e-5 times
max(1, max|JAX|).  The cases with dy = 0 and A, B of order 100 isolate the
two pooled terms, -(2 w4 / N) A and -(8 w4^2 / (N-1)) B (x - mu), which are
about 1/N of dx at the flagship and invisible beside the gate's terms.

(b) The launch geometry K5's wrapper takes (``carafe_head.k5_geometry``:
K3's chunks of pixels, the (g, channel vector) slots of a pixel split over
blockIdx.y by ``slot_split``), decoded as the kernel decodes its blocks:
every (pixel, lane) covered exactly once and the db partials pooling to
db, at every configuration's flat map and at the wide shapes that used to
be refused; the grid fills 4 x 132 blocks where the map allows.  The same
for K-C's wide shapes (``carafe_kernels.fwd_geometry``).  Pure Python.
"""

import numpy as np
import pytest
import torch

import cswin_simam_unet_tpu.ops.pallas_simam_head as sh

from cswin_simam_unet_tpu_torch.configs import CONFIGS, TRAIN_CONFIGS
from cswin_simam_unet_tpu_torch.ops import carafe_head, carafe_kernels
from cswin_simam_unet_tpu_torch.ops.simam import LAMBDA

TOL = 2e-5
MIN_BLOCKS = 4 * 132
TH, W, G, C = 4, 6, 4, 8  # one image of (TH, W) pixels, G slots of C channels


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _inputs(F, zero_dy, B=2):
    """fb (B, TH, W, G*C), dy, mu, v, A, Bq (B, C), w (C, F), float32."""
    fb = _rand((B, TH, W, G * C), 0, 2.0) + 0.5
    dy = np.zeros((B, TH, W, G * F), np.float32) if zero_dy else _rand((B, TH, W, G * F), 1)
    pooled = fb.reshape(B, TH * W * G, C)
    mu = pooled.mean(1)
    v = pooled.var(1, ddof=1) + np.abs(_rand((B, C), 2, 0.1))
    scale = 100.0 if zero_dy else 1.0
    A, Bq = _rand((B, C), 3, scale), _rand((B, C), 4, scale)
    return fb, dy, mu, v, A, Bq, _rand((C, F), 5, C ** -0.5)


def _jax_bwd2(fb, dy, mu, v, A, Bq, w, gate):
    """JAX's kernel bodies, one image a call on numpy refs -> (dx, db (C,))."""
    B, _, _, GC = fb.shape
    F = w.shape[1]
    kwt = np.asarray(sh._kron_eye(w.T, G, np.float32))  # (G*F, G*C)
    N = TH * W * G
    dx = np.zeros_like(fb)
    db = np.zeros(C, np.float64)
    for b in range(B):
        dx_ref = np.zeros((1, TH, W, GC), np.float32)
        db_ref = np.zeros((1, 1, 8, GC), np.float32)
        if gate:
            tile = [np.tile(t[b], G)[None, None, :] for t in (mu, v, A, Bq)]
            sh._bwd2_kernel(fb[b:b + 1], dy[b:b + 1], *tile, np.zeros(GC, np.float32), kwt,
                            dx_ref, db_ref, lam=LAMBDA, G=G, F=F, N=N, n=N - 1)
        else:
            sh._bwd2_nogate_kernel(dy[b:b + 1], kwt, dx_ref, db_ref, G=G, F=F)
        dx[b] = dx_ref[0]
        db += db_ref[0, 0, 0].reshape(G, C).sum(0)
    return dx, db


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("zero_dy", [False, True])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("F", [1, 3, 8])
def test_plain_k5_against_the_jax_kernel_bodies(F, gate, zero_dy):
    fb, dy, mu, v, A, Bq, w = _inputs(F, zero_dy)
    want_dx, want_db = _jax_bwd2(fb, dy, mu, v, A, Bq, w, gate)
    got_dx, got_db = carafe_head.head_bwd2_reference(
        *(torch.from_numpy(t) for t in (fb, dy, mu, v, A, Bq, w)), G, LAMBDA, gate)
    _close(got_dx, want_dx)
    _close(got_db, want_db)
    if gate and zero_dy:  # dx is the two pooled terms alone, and they are not small
        w4 = 1.0 / (4.0 * (v + LAMBDA))
        N = TH * W * G
        xc = fb.reshape(2, TH, W, G, C) - mu[:, None, None, None]
        pooled = (-(2.0 * w4 / N) * A)[:, None, None, None] \
            - (8.0 * w4 * w4 / (N - 1) * Bq)[:, None, None, None] * xc
        _close(want_dx, pooled.reshape(fb.shape))
        assert float(np.abs(want_dx).max()) > 0.1


def _flat_maps():
    """(label, B, H, W, C, G, vec) of every configuration's head flat map
    (its training batch, img/4, embed channels, S 4) in float32 and bf16,
    and the wide shapes the wrappers used to refuse."""
    maps = []
    for name in sorted(CONFIGS):
        cfg = CONFIGS[name]
        if cfg.family != "cswin":  # the UNet family has no CARAFE head
            continue
        r = cfg.img_size // 4
        for vec in (4, 8):
            maps.append((name, TRAIN_CONFIGS[name].batch_size, r, r, cfg.embed_dim, 16, vec))
    maps += [("wide bf16", 1, 7, 9, 1024, 16, 8), ("wide f32", 2, 5, 3, 1024, 16, 4),
             ("wide scalar", 1, 3, 11, 100, 16, 1), ("odd slices", 1, 4, 4, 8 * 257, 1, 8)]
    return maps


@pytest.mark.parametrize("label,B,H,W,C,G_,vec", _flat_maps())
def test_k5_geometry_covers_each_pixel_lane_once(label, B, H, W, C, G_, vec):
    g = carafe_head.k5_geometry(B, H, W, C, G_, vec)
    slots, HW = G_ * (C // vec), H * W
    assert g["threads"] <= carafe_head.SLOT_THREADS and g["splits"] >= 1
    assert g["threads"] * g["splits"] >= slots > g["threads"] * (g["splits"] - 1)
    if slots <= carafe_head.SLOT_THREADS:  # the configured maps: one slice
        assert (g["threads"], g["splits"]) == (slots, 1)
    # pixels: block x is chunk x % chunks of image x // chunks
    pixels = np.zeros(B * HW, np.int64)
    for block in range(g["blocks"]):
        chunk, b = block % g["chunks"], block // g["chunks"]
        start, stop = chunk * g["pixels"], min(HW, (chunk + 1) * g["pixels"])
        assert start < stop
        pixels[b * HW + start:b * HW + stop] += 1
    # lanes: thread t of slice y owns slot y*threads + t, if below the slots
    lanes = np.zeros((G_, C // vec), np.int64)
    for y in range(g["splits"]):
        for t in range(g["threads"]):
            slot = y * g["threads"] + t
            if slot < slots:
                lanes[divmod(slot, C // vec)] += 1
    # the grid is their product, so each (pixel, lane) is covered once
    assert (pixels == 1).all() and (lanes == 1).all()
    if B * -(-HW // carafe_head.K5_PIXELS[-1]) >= MIN_BLOCKS:
        assert g["blocks"] >= MIN_BLOCKS, g


@pytest.mark.parametrize("B,H,W,C,G_,vec", [(2, 5, 7, 16, 4, 4), (1, 9, 11, 1024, 16, 8)])
def test_k5_db_partials_pool_to_db(B, H, W, C, G_, vec):
    """The (blocks, G*C) partial rows, each block's sums over its chunk for
    its slice of the lanes, summed over the blocks and the G slots as the
    wrapper sums them, give db (C,)."""
    g = carafe_head.k5_geometry(B, H, W, C, G_, vec, sms=4)
    dx = np.random.RandomState(0).randn(B, H * W, G_ * C)
    part = np.full((g["blocks"], G_ * C), np.nan)
    for block in range(g["blocks"]):
        chunk, b = block % g["chunks"], block // g["chunks"]
        rows = dx[b, chunk * g["pixels"]:(chunk + 1) * g["pixels"]]
        for y in range(g["splits"]):
            s0 = y * g["threads"] * vec
            s1 = min(G_ * C, (y + 1) * g["threads"] * vec)
            part[block, s0:s1] = rows[:, s0:s1].sum(0)
    got = part.reshape(g["blocks"] * G_, C).sum(0)
    np.testing.assert_allclose(got, dx.reshape(-1, G_, C).sum((0, 1)), rtol=1e-12)


@pytest.mark.parametrize("S,C,vec", [(1, 4096, 8), (2, 2560, 8), (1, 300, 1), (2, 2052, 4)])
def test_kc_wide_geometry_covers_each_pixel_vector_once(S, C, vec):
    """K-C above 256 channel vectors a pixel: one pixel a pass, the vectors
    in even slices over blockIdx.y, each (pixel, vector) once."""
    B, H, W = 2, 9, 13
    g = carafe_kernels.fwd_geometry(B, H, W, C, S, vec, 132)
    cv = C // vec
    assert g["pass_pixels"] == 1 and g["slices"] > 1
    assert g["threads"] == g["slice"] == carafe_head.h1_slice(cv, 1) <= carafe_head.H1_THREADS
    assert g["smem"] == carafe_head.h1_smem_bytes(C, S, 1, stats=False) <= carafe_head.H1_SMEM
    vectors = np.zeros(cv, np.int64)
    for y in range(g["slices"]):
        ids = y * g["slice"] + np.arange(g["threads"])  # cv = y*slice + tid (pp 1)
        vectors[ids[ids < cv]] += 1
    pixels = np.zeros(B * H * W, np.int64)
    for block in range(g["blocks"]):
        chunk, b = block % g["chunks"], block // g["chunks"]
        start, stop = chunk * g["pixels"], min(H * W, (chunk + 1) * g["pixels"])
        pixels[b * H * W + start:b * H * W + stop] += 1
    assert (vectors == 1).all() and (pixels == 1).all()
    with pytest.raises(ValueError, match="K-H1"):  # K-H1 with the moments takes no slices
        carafe_head.h1_geometry(B, H, W, C, S, vec, 132)
