"""PyTorch port: the launch shape of K-LN' (the LayerNorm backward) on the CPU.

The wrapper takes K-LN''s launch shape from ``layernorm.bwd_geometry``,
which mirrors ``csrc/layernorm.cu::ln_bwd_geometry`` (the card tests hold
the two against each other).  At every LayerNorm shape of
``cswin_simam_512`` (batch 8), ``cswinunet`` (batch 2) and
``cswin_simam_2048`` (batch 1), and at odd shapes (a single row, ragged last
blocks, channel counts off the vector width), in both dtypes with aligned
rows and without: every row is visited by exactly one (block, warp, lane
group); the body matches C, the dtype and the alignment; the partials have
the block count's rows; the launch fills the card where M allows; and C
outside 1..512 is refused.  A numpy model of the kernel's fixed-order dg/db
sum over the geometry's partition of rows matches ``ln_bwd_reference``.
Pure Python: no kernel runs here.
"""

import numpy as np
import pytest
import torch

from cswin_simam_unet_tpu_torch.configs import CONFIGS, TRAIN_CONFIGS
from cswin_simam_unet_tpu_torch.ops import layernorm

SMS = layernorm.H100_SMS
TOL_SUM = 2e-5  # x max(1, max|plain|), float32 sums in another order


def _config_shapes():
    shapes = set()
    for name in ("cswin_simam_512", "cswinunet", "cswin_simam_2048"):
        cfg, B = CONFIGS[name], TRAIN_CONFIGS[name].batch_size
        r = cfg.img_size // 4
        shapes |= {(B * (r >> s) ** 2, cfg.embed_dim << s) for s in range(4)}
    return sorted(shapes)


CONFIG_SHAPES = _config_shapes()
ODD_SHAPES = [(M, C) for M in (1, 37, 131, 2049) for C in (8, 33, 96, 100, 512)]
DTYPES = [torch.float32, torch.bfloat16]


def test_config_shapes_are_the_twelve_layernorms():
    assert len(CONFIG_SHAPES) == 12
    assert (131072, 64) in CONFIG_SHAPES and (392, 512) in CONFIG_SHAPES
    assert (262144, 64) in CONFIG_SHAPES


@pytest.mark.parametrize("M,C", CONFIG_SHAPES + ODD_SHAPES)
def test_bwd_geometry_owns_every_row_once(M, C):
    for dtype in DTYPES:
        for aligned in (True, False):
            _check_geometry(M, C, dtype, aligned)


def _check_geometry(M, C, dtype, aligned):
    geo = layernorm.bwd_geometry(M, C, dtype, aligned, SMS)
    owners = layernorm.bwd_row_owners(geo, M)
    assert np.array_equal(np.sort(owners[:, 0]), np.arange(M))
    gpw = 32 // geo["lanes"]
    assert (owners[:, 1] < geo["blocks"]).all() and (owners[:, 2] < geo["warps"]).all()
    assert (owners[:, 3] < gpw).all()
    assert (owners[:, 1] == owners[:, 0] // geo["rows"]).all()  # a block owns one run
    # the body: 16-byte loads where C and the alignment allow them
    per16 = 16 // dtype.itemsize
    vec = aligned and C % per16 == 0
    assert geo["body"] == ("vec" if vec else "scalar") and geo["vec"] == (per16 if vec else 1)
    nv = C // geo["vec"]
    assert geo["lanes"] == min(32, 1 << (nv - 1).bit_length())
    assert geo["lanes"] * geo["vpl"] >= nv > geo["lanes"] * geo["vpl"] // 2 or geo["vpl"] == 1
    assert geo["in_flight"] == max(1, layernorm.BWD_LOADS // geo["vpl"])


@pytest.mark.parametrize("M,C", CONFIG_SHAPES + ODD_SHAPES)
def test_bwd_geometry_fills_the_card(M, C):
    """At most two blocks an SM (one wave at the launch bounds); a block on
    every SM and about two blocks' worth of warps on each where M has the
    rows for them; no warp without a row to start with."""
    for dtype in DTYPES:
        geo = layernorm.bwd_geometry(M, C, dtype, True, SMS)
        gpw = 32 // geo["lanes"]
        units = -(-M // gpw)  # a warp's rows at a time
        assert geo["blocks"] <= layernorm.BWD_BLOCKS_PER_SM * SMS
        assert geo["blocks"] >= min(SMS, units)
        most = layernorm.BWD_BLOCKS_PER_SM * SMS * layernorm.BWD_MAX_WARPS
        assert geo["blocks"] * geo["warps"] >= 0.9 * min(most, units)
        assert geo["rows"] % gpw == 0 and geo["warps"] * gpw <= geo["rows"]
        assert (geo["blocks"] - 1) * geo["rows"] < M <= geo["blocks"] * geo["rows"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_bwd_buffers_hold_the_partials(dtype):
    """The partials the wrapper allocates: a row a block, dg beside db."""
    for M, C in ((131072, 64), (392, 512), (131, 100), (1, 8)):
        x = torch.zeros(M, C, dtype=dtype)
        geo, dx, part, sums = layernorm.bwd_buffers(x, x, SMS)
        assert geo == layernorm.bwd_geometry(M, C, dtype, x.data_ptr() % 16 == 0, SMS)
        assert dx.shape == x.shape and dx.dtype == dtype
        assert part.shape == (geo["blocks"], 2 * C) and part.dtype == torch.float32
        assert sums.shape == (2, C) and sums.dtype == torch.float32


@pytest.mark.parametrize("M,C", [(0, 64), (4, 0), (4, 513)])
def test_bwd_geometry_refuses(M, C):
    with pytest.raises(ValueError, match="K-LN'"):
        layernorm.bwd_geometry(M, C, torch.bfloat16)


def test_wrapper_refuses_wide_rows():
    with pytest.raises(ValueError, match="channels"):
        layernorm.kernel_bwd(torch.zeros(4, 513), torch.ones(513), torch.zeros(4, 513))


@pytest.mark.parametrize("M,C", [(1, 8), (131, 100), (2049, 64), (263 * 8 + 1, 33),
                                 (392, 512), (1568, 256)])
def test_fixed_order_sum_over_the_partition(M, C):
    """dg and db as the kernel sums them: each block's rows into one
    partial, then the partials in block order, over the geometry's
    partition of rows; against the plain backward's sums."""
    rs = np.random.RandomState(M + C)
    x = (rs.randn(M, C) * 2.0 + 0.5).astype(np.float32)
    dy = rs.randn(M, C).astype(np.float32)
    g = (rs.randn(C) * 0.3 + 1.0).astype(np.float32)
    mu = x.mean(1, keepdims=True)
    rstd = 1.0 / np.sqrt(np.maximum((x * x).mean(1, keepdims=True) - mu * mu, 0.0) + 1e-5)
    xhat = ((x - mu) * rstd).astype(np.float32)
    geo = layernorm.bwd_geometry(M, C, torch.float32, True, SMS)
    owners = layernorm.bwd_row_owners(geo, M)
    order = np.argsort(owners[:, 1], kind="stable")
    rows, blocks = owners[order, 0], owners[order, 1]
    starts = np.searchsorted(blocks, np.arange(geo["blocks"]))
    part = np.stack([np.add.reduceat((dy * xhat)[rows], starts, axis=0),
                     np.add.reduceat(dy[rows], starts, axis=0)], axis=1)
    assert part.shape == (geo["blocks"], 2, C) and part.dtype == np.float32
    total = np.zeros((2, C), dtype=np.float32)
    for b in range(geo["blocks"]):
        total += part[b]
    _, dg, db = layernorm.ln_bwd_reference(torch.from_numpy(x), torch.from_numpy(g),
                                           torch.from_numpy(dy))
    for got, want in zip(total, (dg.numpy(), db.numpy())):
        tol = TOL_SUM * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= tol
