"""PyTorch port: the launch geometry of K4 and K3, the fused head's backward
kernels, on the CPU.

The wrappers take their blocks from ``carafe_head.k4_geometry`` and
``carafe_head.k3_geometry``, which mirror the C side's shared-memory formula
and block decode (``csrc/carafe_head_bwd.cu``, ``csrc/simam_head.cu``).
Every configured head geometry (the training configs' batch at 448^2,
512^2, 1024^2 and 2048^2; S 2 and 4; float32 and bf16; gate on and off; one
and eight classes) must fit a block's shared memory, give a grid of at
least 4 x 132 blocks, and cover each own pixel exactly once.  Pure Python:
no kernel runs here.
"""

import numpy as np
import pytest

from cswin_simam_unet_tpu_torch.configs import CONFIGS, TRAIN_CONFIGS
from cswin_simam_unet_tpu_torch.ops import carafe_head, carafe_kernels

MIN_BLOCKS = 4 * 132
DTYPES = {"float32": (4, 4), "bfloat16": (8, 2)}  # (vec, element bytes)


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


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k3_geometry_at_every_head(name):
    B, H, _ = _head(name)
    g = carafe_head.k3_geometry(B, H, H)
    assert g["blocks"] >= MIN_BLOCKS, g
    counts = np.zeros(B * H * H, dtype=np.int32)
    for block in range(g["blocks"]):  # the kernel's decode: chunk, then image
        chunk, b = block % g["chunks"], block // g["chunks"]
        start = chunk * g["pixels"]
        stop = min(H * H, start + g["pixels"])
        assert start < stop
        counts[b * H * H + start:b * H * H + stop] += 1
    assert (counts == 1).all()


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
            carafe_kernels.bwd_pixels_per_block(C, S, vec, elem, 512)
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
