"""PyTorch port: the launch geometry of the decoder's CARAFE kernels, K-C
(forward, on K-H1's body) and K-C' (backward, on K4's body with the
cotangent staged as it is), on the CPU.

The wrappers (``ops/carafe_kernels.py``) take their blocks from
``carafe_kernels.fwd_geometry`` (K-H1's ``h1_geometry`` without the
moments) and ``carafe_kernels.bwd_geometry`` (K4's ``k4_geometry`` sized
for the ring of dacc, p and x).  At every decoder CARAFE of every configuration, at its training
batch (and batch 1 and 2 at 1024^2 and 2048^2), and at the S 4 head path
(the unfused chain above 8 classes, ``CARAFE(flat_raw)``), each geometry
must fit a block's threads and shared memory, cover each pixel exactly
once, and give a grid of at least 4 x 132 blocks where its rules allow
(else it has taken its shortest run or fewest passes).  Every shape the
first K-C and K-C' launches took is taken again, the forward at S 1 with
more than 256 channel vectors included (in slices of the vectors).  Pure
Python: no kernel runs here.
"""

import numpy as np
import pytest

from cswin_simam_unet_tpu_torch.configs import CONFIGS, TRAIN_CONFIGS
from cswin_simam_unet_tpu_torch.ops import carafe_head, carafe_kernels

MIN_BLOCKS = 4 * 132
DTYPES = {"float32": (4, 4), "bfloat16": (8, 2)}  # (vec, element bytes)
# the configs with CARAFEs (the UNet family has none)
CSWIN = sorted(name for name, cfg in CONFIGS.items() if cfg.family == "cswin")
BATCHES = [(name, TRAIN_CONFIGS[name].batch_size) for name in CSWIN] + [
    ("cswin_simam_1024", 1), ("cswin_simam_2048", 2)]


def carafe_shapes(name):
    """(H, C, S) of the decoder's three 2x CARAFEs (upsample4, 3, 2: C =
    embed * 2^s at img / 4 / 2^(s+1)) and of the S 4 head path (embed
    channels at img / 4)."""
    cfg = CONFIGS[name]
    E, r0 = cfg.embed_dim, cfg.img_size // 4
    return [(r0 // 2 ** (s + 1), E * 2 ** s, 2) for s in (2, 1, 0)] + [(r0, E, 4)]


def _vec(name, C):
    vec, elem = DTYPES[CONFIGS[name].dtype]
    return (vec if C % vec == 0 else 1), elem


def fwd_coverage(g, B, HW):
    """Pixels covered by K-C's blocks, each chunk walked pass by pass."""
    counts = np.zeros(B * HW, dtype=np.int32)
    for block in range(g["blocks"]):
        chunk, b = block % g["chunks"], block // g["chunks"]
        start = chunk * g["pixels"]
        stop = min(HW, start + g["pixels"])
        assert start < stop
        for p0 in range(start, stop, g["pass_pixels"]):
            counts[b * HW + p0:b * HW + min(stop, p0 + g["pass_pixels"])] += 1
    return counts


def bwd_coverage(g, B, H, W):
    counts = np.zeros((B, H, W), dtype=np.int32)
    for block in range(g["blocks"]):
        b, y0, y1, x0, x1 = carafe_head.k4_block_pixels(g, H, W, block)
        assert y0 < y1 and x0 < x1, (block, g)
        counts[b, y0:y1, x0:x1] += 1
    return counts


@pytest.mark.parametrize("name,B", BATCHES)
def test_kc_geometry_at_every_decoder_carafe(name, B):
    for H, C, S in carafe_shapes(name):
        vec, _ = _vec(name, C)
        g = carafe_kernels.fwd_geometry(B, H, H, C, S, vec, 132)
        assert g["threads"] == g["pass_pixels"] * (C // vec) <= carafe_head.H1_THREADS
        assert g["slices"] == 1
        assert g["smem"] == carafe_head.h1_smem_bytes(C, S, g["pass_pixels"], stats=False) \
            <= carafe_head.H1_SMEM
        assert g["blocks"] >= MIN_BLOCKS or g["passes"] == 1, (H, C, S, g)
        assert (fwd_coverage(g, B, H * H) == 1).all()


@pytest.mark.parametrize("name,B", BATCHES)
def test_kc_bwd_geometry_at_every_decoder_carafe(name, B):
    for H, C, S in carafe_shapes(name):
        vec, elem = _vec(name, C)
        g = carafe_kernels.bwd_geometry(B, H, H, C, S, vec, elem, 132)
        assert g["threads"] == 32 * g["px"] <= 256
        assert g["smem"] == carafe_head.k4_smem_bytes(C, S, vec, elem, g["px"], 1, False,
                                                      copy=True)
        assert g["smem"] <= carafe_head.K4_SMEM_BUDGET
        assert g["blocks"] >= MIN_BLOCKS or g["rows"] == 1, (H, C, S, g)
        assert g["blocks"] == B * g["runs"] * g["strips"]
        assert (bwd_coverage(g, B, H, H) == 1).all()


@pytest.mark.parametrize("H,C,fwd,bwd", [
    (64, 64, dict(pass_pixels=16, passes=2, blocks=1024), dict(px=8, rows=4, blocks=1024)),
    (32, 128, dict(pass_pixels=16, passes=1, blocks=512), dict(px=8, rows=1, blocks=1024)),
    (16, 256, dict(pass_pixels=8, passes=1, blocks=256), dict(px=8, rows=1, blocks=256)),
])
def test_flagship_decoder_blocks(H, C, fwd, bwd):
    """The flagship's three decoder CARAFEs (512^2, batch 8, bf16)."""
    g = carafe_kernels.fwd_geometry(8, H, H, C, 2, 8, 132)
    assert {k: g[k] for k in fwd} == fwd
    g = carafe_kernels.bwd_geometry(8, H, H, C, 2, 8, 2, 132)
    assert {k: g[k] for k in bwd} == bwd


def _old_launch_took(C, S, vec):
    """The first K-C launch: one thread per (sub-pixel, channel vector)."""
    return S * S * (C // vec) <= 1024


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S", [1, 2, 4])
def test_kc_takes_what_the_old_launch_took(S, dtype):
    """K-C takes every (C, S, vec) the first K-C took, S 1 with more than
    H1_THREADS channel vectors included (one pixel a pass, its vectors in
    slices over blockIdx.y); the scalar path (vec 1) included."""
    vec16, _ = DTYPES[dtype]
    refused = []
    for vec in (vec16, 1):
        for C in range(vec, 1024 * vec + 1, vec):
            if not _old_launch_took(C, S, vec):
                break
            try:
                g = carafe_kernels.fwd_geometry(2, 9, 13, C, S, vec, 132)
            except ValueError:
                refused.append((C, vec))
                continue
            assert (fwd_coverage(g, 2, 9 * 13) == 1).all()
    assert refused == []


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S", [1, 2, 4])
def test_kc_bwd_takes_what_the_old_launch_took(S, dtype):
    """K-C' takes every (C, S, vec) the first K-C' took: S^2*C/vec <= 1024
    threads and a row block under its 100 KB budget at some width."""
    vec16, elem = DTYPES[dtype]
    taken = 0
    for vec in (vec16, 1):
        for C in range(vec, 1024 * vec + 1, vec):
            if not _old_launch_took(C, S, vec):
                break
            S2, nt = S * S, S * S * (C // vec)
            nfloat = (3 * 3 * 9 * S2 + 9 * nt + nt * vec + 9 * S2 + 3) & ~3
            if 4 * nfloat + elem * 3 * 3 * S2 * C > 100 * 1024:  # px 1 did not fit
                continue
            g = carafe_kernels.bwd_geometry(2, 9, 13, C, S, vec, elem, 132)
            assert g["smem"] <= carafe_head.SMEM_LIMIT
            assert (bwd_coverage(g, 2, 9, 13) == 1).all()
            taken += 1
    assert taken > 0


def test_kc_geometries_reject_what_cannot_fit():
    """K-C's block needs the two pass buffers of one pixel's 9*S^2 taps in
    shared memory (S 32 does not fit); its channel vectors no longer bound
    it.  K-C' takes at most 1024 (sub-pixel, channel vector) slots."""
    g = carafe_kernels.fwd_geometry(1, 8, 8, 4096, 1, 8, 132)
    assert (g["pass_pixels"], g["slice"], g["slices"], g["threads"]) == (1, 256, 2, 256)
    with pytest.raises(ValueError, match="K-H1"):
        carafe_kernels.fwd_geometry(1, 8, 8, 64, 32, 8, 132)
    with pytest.raises(ValueError, match="threads"):
        carafe_kernels.bwd_geometry(1, 8, 8, 4096, 2, 8, 2, 132)
