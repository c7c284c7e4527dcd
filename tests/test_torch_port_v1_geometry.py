"""PyTorch port: which body, grid and shared memory the v1 window-attention
kernels K-V1 and K-V1' take for each (dtype, head dim, Np), and what they
refuse, on the CPU.

``ops/window_attention.design`` and ``launch_geometry`` mirror the C entry's
choice (``csu_window_attention_design``, ``csrc/window_attention.cu``): bf16
at head dims 16, 32 and 64 on the tensor cores, the whole-window K-V1'
body where one block holds the window (at most 256 tokens and 227 KB of
shared memory), the tiled dq and dk/dv bodies above; float32 and head dim 8
on the CUDA cores.  Every window of every configuration is checked, and
the limits at each head dim.  A card test holds the mirror against the C
entry.  Pure Python: no kernel runs here.
"""

import pytest
import torch

from cswin_simam_unet_tpu_torch.configs import CONFIGS
from cswin_simam_unet_tpu_torch.ops import window_attention as wa
from cswin_simam_unet_tpu_torch.ops.windows import stripe_geometry

BF16, F32 = torch.bfloat16, torch.float32
DTYPES = {"bfloat16": BF16, "float32": F32}
# the configs with attention (the UNet family has none)
CSWIN = sorted(name for name, cfg in CONFIGS.items() if cfg.family == "cswin")


def branch_windows(name):
    """{(tokens per window, head dim)} of a configuration's attention
    branches: two half-width stripe branches a block, one global branch in
    the last stage (or where the stripe spans the map)."""
    cfg = CONFIGS[name]
    out = set()
    for i, (split, heads) in enumerate(zip(cfg.split_size, cfg.num_heads)):
        reso, dim = cfg.img_size // 4 >> i, cfg.embed_dim << i
        if i == 3 or reso == split:
            out.add((reso * reso, dim // heads))
        else:
            for idx in (0, 1):
                hsp, wsp = stripe_geometry(reso, split, idx)
                out.add((hsp * wsp, (dim // 2) // (heads // 2)))
    return out


@pytest.mark.parametrize("name", CSWIN)
def test_v1_body_at_every_window_of_the_configs(name):
    dtype = DTYPES[CONFIGS[name].dtype]
    for N, D in sorted(branch_windows(name)):
        Np = -(-N // wa.PAD) * wa.PAD
        if Np > wa.MAX_TOKENS:  # v1 refuses what the TPU kernel's N x N block refused
            q = torch.zeros(1, Np, D)
            with pytest.raises(ValueError, match="at most 2048 tokens"):
                wa.window_attention(q, q, q, 1.0, N)
            continue
        body = wa.design(dtype, D, Np)
        if dtype == F32:
            assert body == "fma"
        else:
            assert body == ("whole" if Np <= 256 else "tiled"), (N, D)
        g = wa.launch_geometry(dtype, 8, Np, N, D)
        assert g["body"] == body
        if body == "whole":
            (grid, threads, smem), = g["bwd"]
            assert grid == (8, 1, 1) and threads == 2 * Np <= 512
            assert smem == wa.whole_smem(D, Np, N) <= wa.MAX_SMEM


@pytest.mark.parametrize("D,largest", [(16, 256), (32, 256), (64, 208)])
def test_v1_whole_window_limit(D, largest):
    """The whole-window K-V1' holds up to ``largest`` tokens at head dim D
    (a warp per 16 rows, at most 16; 227 KB of shared memory); one more row
    of 16 takes the tiled bodies, as does every window up to 2048."""
    assert wa.design(BF16, D, largest) == "whole"
    assert wa.whole_smem(D, largest, largest) <= wa.MAX_SMEM
    for Np in (largest + 1, largest + 16, 512, 2048):
        assert wa.design(BF16, D, Np) == "tiled"
    assert wa.design(BF16, D, 1) == "whole"
    assert wa.design(F32, D, largest) == "fma"
    assert wa.design(BF16, 8, 64) == "fma"


def test_v1_whole_window_shared_memory():
    """q * scale, k, v, dO, L, delta and ds^T at the flagship's windows, and
    ds^T cut to the attended keys."""
    assert wa.whole_smem(32, 256, 256) == 4 * 256 * 40 * 2 + 2 * 256 * 4 + 256 * 264 * 2
    assert wa.whole_smem(32, 128, 128) == 76800
    assert wa.whole_smem(32, 112, 98) == wa.whole_smem(32, 112, 112)  # 98 keys: 7 rows of 16
    assert wa.whole_smem(32, 112, 1) < wa.whole_smem(32, 112, 98)


@pytest.mark.parametrize("dtype,D", [(BF16, 16), (BF16, 32), (BF16, 64), (F32, 32),
                                     (F32, 64), (BF16, 8)])
def test_v1_grids_cover_every_row(dtype, D):
    """Each launch's blocks cover the group's Np rows, and a tensor-core
    block's shared memory fits; 64 query rows a tensor-core block, a thread
    a row in the CUDA-core bodies (two lanes at head dim 64)."""
    for Np in (1, 16, 98, 112, 128, 256, 500, 2048):
        g = wa.launch_geometry(dtype, 5, Np, max(1, Np - 3), D)
        for grid, threads, smem in [g["fwd"], *g["bwd"]]:
            assert grid[0] == 5 and smem <= wa.MAX_SMEM
            if g["body"] == "fma":
                rows = threads // (2 if D > 32 else 1)
                assert grid[1] * rows >= Np > (grid[1] - 1) * rows and smem == 0
            elif threads == wa.MMA_THREADS:
                assert grid[2] * wa.MMA_ROWS >= Np > (grid[2] - 1) * wa.MMA_ROWS
            else:  # the whole-window block: a warp per 16 rows
                assert threads == 32 * -(-Np // 16)
        assert len(g["bwd"]) == (1 if g["body"] == "whole" else 2)


def test_v1_refusals():
    """What neither direction takes raises on every device; the kernel
    entries refuse CPU tensors instead of falling back to the plain
    versions."""
    x = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="n_valid"):
        wa.window_attention(x, x, x, 1.0, 0)
    with pytest.raises(ValueError, match="n_valid"):
        wa.window_attention(x, x, x, 1.0, 65)
    with pytest.raises(ValueError, match="one"):
        wa.window_attention(x, x[:, :32], x, 1.0, 16)
    with pytest.raises(ValueError, match="head dim"):
        wa.kernel_fwd(torch.zeros(2, 64, 24), torch.zeros(2, 64, 24), torch.zeros(2, 64, 24),
                      1.0, 64)
    with pytest.raises(ValueError, match="CUDA"):
        wa.kernel_fwd(x, x, x, 1.0, 64)
    with pytest.raises(ValueError, match="CUDA"):
        wa.kernel_bwd(x, x, x, torch.zeros(2, 64), x, 1.0, 64)
