"""PyTorch port: the launch geometry of the fused head's four kernels, K-H1
and K-H2 (forward) and K4 and K3 (backward), on the CPU.

The wrappers take their blocks from ``carafe_head.h1_geometry``,
``h2_geometry``, ``k4_geometry`` and ``k3_geometry``, which mirror the C
side's shared-memory formulas and block decodes (``csrc/carafe_head_fwd.cu``,
``csrc/simam_head.cu``, ``csrc/carafe_head_bwd.cu``).  Every configured head
geometry (the training configs' batch at 448^2, 512^2, 1024^2 and 2048^2;
S 2 and 4; float32 and bf16; gate on and off; one and eight classes) must
fit a block's threads and shared memory, give a grid of at least 4 x 132
blocks, and cover each own pixel exactly once; K-H1's per-block moment sums,
laid out as its wrapper lays them out, must pool to the statistics of the
whole map.  Pure Python: no kernel runs here.
"""

import numpy as np
import pytest
import torch

from cswin_simam_unet_tpu_torch.configs import CONFIGS, TRAIN_CONFIGS
from cswin_simam_unet_tpu_torch.ops import carafe_head
from cswin_simam_unet_tpu_torch.ops.simam import pooled_stats

MIN_BLOCKS = 4 * 132
DTYPES = {"float32": (4, 4), "bfloat16": (8, 2)}  # (vec, element bytes)


def old_bwd_pixels_per_block(C, S, vec, elem, W):
    """The pixels of a row that the first K-C' launch gave a block (the most,
    up to 16 and W, whose staged rows fit its 100 KB budget); raises where
    none fits.  K4 and K-C' once shared that launch."""
    S2, nt = S * S, S * S * (C // vec)
    for px in (16, 8, 4, 2, 1):
        pw = px + 2
        nfloat = (3 * pw * 9 * S2 + 9 * nt + nt * vec + 9 * S2 + 3) & ~3
        if px <= max(W, 1) and 4 * nfloat + elem * 3 * pw * S2 * C <= 100 * 1024:
            return px
    raise ValueError(f"a CARAFE backward block of C={C}, S={S} does not fit shared memory")


def _head(name):
    cfg = CONFIGS[name]
    return TRAIN_CONFIGS[name].batch_size, cfg.img_size // 4, cfg.embed_dim


def _k4_coverage(geom, B, H, W):
    counts = np.zeros((B, H, W), dtype=np.int32)
    for block in range(geom["blocks"]):
        b, y0, y1, x0, x1 = carafe_head.k4_block_pixels(geom, H, W, block)
        assert y0 < y1 and x0 < x1, (block, geom)
        counts[b, y0:y1, x0:x1] += 1
    return counts


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k4_geometry_at_every_head(name, S, dtype):
    B, H, C = _head(name)
    vec, elem = DTYPES[dtype]
    for gate in (True, False):
        for F in (1, 8):
            g = carafe_head.k4_geometry(B, H, H, C, S, vec, elem, F, gate)
            assert g["smem"] == carafe_head.k4_smem_bytes(C, S, vec, elem, g["px"], F, gate)
            assert g["smem"] <= carafe_head.K4_SMEM_BUDGET <= carafe_head.SMEM_LIMIT
            assert g["threads"] == 32 * g["px"] <= 256
            assert g["blocks"] >= MIN_BLOCKS, g
            assert g["blocks"] == B * -(-H // g["rows"]) * -(-H // g["px"])
            assert (_k4_coverage(g, B, H, H) == 1).all()


def _chunk_coverage(g, B, HW, step=None):
    """Pixels covered by the blocks of a chunked launch (K3, K-H2, K-H1),
    decoded as the kernels decode blockIdx.x: chunk, then image; with
    ``step``, each chunk walked in passes of ``step`` pixels (K-H1)."""
    counts = np.zeros(B * HW, dtype=np.int32)
    for block in range(g["blocks"]):
        chunk, b = block % g["chunks"], block // g["chunks"]
        start = chunk * g["pixels"]
        stop = min(HW, start + g["pixels"])
        assert start < stop
        for p0 in range(start, stop, step or g["pixels"]):
            counts[b * HW + p0:b * HW + min(stop, p0 + (step or g["pixels"]))] += 1
    return counts


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k3_geometry_at_every_head(name):
    B, H, _ = _head(name)
    g = carafe_head.k3_geometry(B, H, H)
    assert g["blocks"] >= MIN_BLOCKS, g
    assert (_chunk_coverage(g, B, H * H) == 1).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_h2_geometry_at_every_head(name, dtype):
    """K-H2: K3's chunks, and one lane a channel vector at every configured
    head (the constants in registers), a group of lanes within a warp."""
    B, H, C = _head(name)
    vec, _ = DTYPES[dtype]
    for S in (2, 4):
        g = carafe_head.h2_geometry(B, H, H, C, S * S, vec)
        assert g["blocks"] >= MIN_BLOCKS, g
        assert g["one"] and g["lanes"] == C // vec and 32 % g["lanes"] == 0
        assert g["threads"] == S * S * g["lanes"] <= carafe_head.H2_THREADS
        assert (_chunk_coverage(g, B, H * H) == 1).all()


@pytest.mark.parametrize("C,vec,lanes,one", [(6, 1, 4, False), (24, 8, 2, False),
                                             (512, 4, 32, False), (8, 8, 1, True),
                                             (16, 4, 4, True), (2, 1, 2, False)])
def test_h2_lanes_for_every_channel_count(C, vec, lanes, one):
    """Channel vectors that are not a power of two up to 32 take the
    strided path; scalar channels never take the one-vector path."""
    g = carafe_head.h2_geometry(2, 5, 7, C, 4, vec)
    assert (g["lanes"], g["one"]) == (lanes, one)
    assert (_chunk_coverage(g, 2, 35) == 1).all()


def test_h2_geometry_rejects_what_cannot_fit():
    """K-H2 takes any G that JAX's simam_head takes: more groups than a
    block holds go in slices of whole groups over blockIdx.y (512 groups:
    two slices of 256; 17 * 31: 17 slices of 31).  Only slices past the
    grid's height raise (a prime G above 65535)."""
    g = carafe_head.h2_geometry(1, 8, 8, 8, 512, 8)
    assert (g["lanes"], g["groups"], g["group_splits"], g["threads"]) == (1, 256, 2, 256)
    g = carafe_head.h2_geometry(1, 8, 8, 64, 17 * 31, 8)
    assert (g["groups"], g["group_splits"]) == (31, 17)
    with pytest.raises(ValueError, match="K-H2"):
        carafe_head.h2_geometry(1, 8, 8, 8, 65537, 8)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_h1_geometry_at_every_head(name, S, dtype):
    B, H, C = _head(name)
    vec, _ = DTYPES[dtype]
    g = carafe_head.h1_geometry(B, H, H, C, S, vec)
    assert g["blocks"] >= MIN_BLOCKS, g
    assert g["threads"] == g["pass_pixels"] * (C // vec) <= carafe_head.H1_THREADS
    assert g["smem"] == carafe_head.h1_smem_bytes(C, S, g["pass_pixels"]) \
        <= carafe_head.H1_SMEM
    assert g["pixels"] == g["passes"] * g["pass_pixels"]
    assert (_chunk_coverage(g, B, H * H, g["pass_pixels"]) == 1).all()


@pytest.mark.parametrize("B,H,W,C,S,vec", [(2, 7, 13, 16, 4, 4), (1, 5, 3, 6, 2, 1),
                                           (3, 9, 11, 64, 4, 8), (2, 4, 4, 24, 8, 8)])
def test_h1_moment_partials_pool_to_the_map_statistics(B, H, W, C, S, vec):
    """K-H1's partials as the wrapper lays them out, (B, chunks, C): each
    block's sums over its chunk and every sub-pixel, summed over the chunks
    and pooled with groups=1, give the per-channel statistics of the whole
    flat map (which pooled_stats takes per lane with groups=S^2)."""
    g = carafe_head.h1_geometry(B, H, W, C, S, vec)
    G = S * S
    fb = np.random.RandomState(0).randn(B, H * W, G, C)
    s1 = np.zeros((B, g["chunks"], C))
    s2 = np.zeros((B, g["chunks"], C))
    for block in range(g["blocks"]):
        chunk, b = block % g["chunks"], block // g["chunks"]
        part = fb[b, chunk * g["pixels"]:(chunk + 1) * g["pixels"]]
        s1[b, chunk] = part.sum(axis=(0, 1))
        s2[b, chunk] = (part * part).sum(axis=(0, 1))
    got = pooled_stats(torch.from_numpy(s1).sum(1), torch.from_numpy(s2).sum(1),
                       H * W * G, 1)
    flat = torch.from_numpy(fb.reshape(B, H * W, G * C))
    want = pooled_stats(flat.sum(1), (flat * flat).sum(1), H * W * G, G)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)


def test_h1_geometry_rejects_what_cannot_fit():
    with pytest.raises(ValueError, match="K-H1"):
        carafe_head.h1_geometry(1, 8, 8, 4096, 4, 8)
    with pytest.raises(ValueError, match="K-H1"):
        carafe_head.h1_geometry(1, 8, 8, 64, 32, 8)


@pytest.mark.parametrize("H,W,tile", [(7, 13, (4, 8)), (1, 5, (4, 2)), (9, 3, (8, 4)),
                                      (5, 8, (4, 8))])
def test_k4_ragged_tiles_cover_once(H, W, tile):
    """Runs and strips that do not divide the image: a single row, a single
    strip, H = rows + 1."""
    g = carafe_head.k4_geometry(2, H, W, 16, 4, 4, 4, 3, True, tile=tile)
    assert (g["rows"], g["px"]) == tile
    assert (_k4_coverage(g, 2, H, W) == 1).all()


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k4_takes_every_geometry_the_old_wrapper_took(S, dtype):
    """Every C the previous K4 launch accepted (a row block under its 100 KB
    budget, S^2*C/vec <= 1024 threads) fits K4's block at 8 classes."""
    vec, elem = DTYPES[dtype]
    taken = 0
    for C in range(vec, 4096, vec):
        if S * S * C // vec > 1024:
            break
        try:
            old_bwd_pixels_per_block(C, S, vec, elem, 512)
        except ValueError:
            continue
        for gate in (True, False):
            g = carafe_head.k4_geometry(1, 64, 512, C, S, vec, elem, 8, gate)
            assert g["smem"] <= carafe_head.SMEM_LIMIT
        taken += 1
    assert taken > 0


def test_k4_geometry_rejects_what_cannot_fit():
    with pytest.raises(ValueError, match="threads"):
        carafe_head.k4_geometry(1, 8, 8, 4096, 4, 8, 2, 1, True)
    with pytest.raises(ValueError, match="tile"):
        carafe_head.k4_geometry(1, 8, 8, 64, 4, 8, 2, 1, True, tile=(4, 16))
