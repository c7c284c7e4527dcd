"""PyTorch port, tensor parallelism without a process group: the partition
rules against JAX's, the attention mask at a head offset, a one-rank
``('data', 'model')`` step, and the refusals.

* ``params_shardings`` against JAX's ``params_shardings`` of the same
  model, JAX's parameters traced by ``jax.eval_shape`` (nothing compiled),
  their names and split dimensions carried to the port's by
  ``compat.cswin_state_dict`` (every JAX leaf marked with its number and,
  along its split dimension, the index).  Heads (4, 4, 4, 4) on a (1, 2)
  mesh: every name and dimension JAX splits, the port splits, transposed to
  torch's layout.  JAX's heads (2, 2, 2, 2): the names JAX splits and the
  port replicates are exactly the attention groups (qkv, proj, get_v) of
  the blocks whose branch heads do not divide by 2;
* ``window_keep_mask(head0=h)`` is heads [h, h + n) of the full mask, and
  ``head0=0`` is the mask as it was; the same for the plain flash path;
* a ``(1, 1)`` mesh whose model axis splits every block (one rank holds
  every shard, its collectives none) trains as the model without a mesh,
  bit for bit;
* what is refused: a mesh shape that is not the world's, an axis the port
  has no mesh for, the segmented step on a ``model`` axis, a rule outside
  the CSWin blocks' groups, a group split in part, sharding twice.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cswin_simam_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_simam_unet_tpu.parallel import make_mesh as jax_make_mesh
from cswin_simam_unet_tpu.parallel import params_shardings as jax_params_shardings

from cswin_simam_unet_tpu_torch.compat import cswin_state_dict
from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.ops import dropout, flash_attention
from cswin_simam_unet_tpu_torch.parallel import (Mesh, Rule, gather_state, make_mesh,
                                                 params_shardings, partition_rules_cswin,
                                                 shard_state)
from cswin_simam_unet_tpu_torch.train import engine
from cswin_simam_unet_tpu_torch.train.segmented import make_segmented_train_step

from test_torch_port_train import _disc_batch

TINY = dict(img_size=64, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2))
DROPS = dict(drop_rate=0.3, attn_drop_rate=0.3, drop_path_rate=0.3)
ATTN = ("qkv.weight", "qkv.bias", "proj.weight", "get_v.weight", "get_v.bias")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fake_mesh(d: int, m: int) -> Mesh:
    """A (d, m) mesh record for the rules (no process group is needed to
    compute shardings)."""
    return Mesh(d * m, 0, torch.device("cpu"), ("data", "model"), (d, m))


def _jax_split(heads) -> dict:
    """{port name: port dimension} of every parameter JAX's rules split on
    a (1, 2) mesh."""
    jm = JaxCSWinUNet(**TINY, num_heads=heads, use_simam=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    shardings = jax_params_shardings(shapes, jax_make_mesh((1, 2), ("data", "model"),
                                                           jax.devices()[:2]))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    specs = jax.tree_util.tree_leaves(shardings)
    marked = []
    for i, (leaf, s) in enumerate(zip(leaves, specs)):
        dims = [d for d, axis in enumerate(s.spec) if axis is not None]
        value = np.full(leaf.shape, 1000.0 * i, np.float32)
        if dims:  # the index along the split dimension
            shape = [1] * len(leaf.shape)
            shape[dims[0]] = leaf.shape[dims[0]]
            value = value + np.arange(leaf.shape[dims[0]], dtype=np.float32).reshape(shape)
        marked.append(value)
    converted = cswin_state_dict({"params": jax.tree_util.tree_unflatten(tree, marked)},
                                 TINY["depth"])
    out = {}
    for name, value in converted.items():
        spec = specs[int(value.flat[0] // 1000)].spec
        if spec == P():
            continue
        varying = [d for d in range(value.ndim) if value.shape[d] > 1
                   and not np.all(np.take(value, [0], axis=d) == value)]
        assert len(varying) == 1, (name, varying)
        out[name] = varying[0]
    return out


def _port_split(heads) -> dict:
    model = CSWinUNet(**TINY, num_heads=heads, use_simam=True, device="cpu")
    return {n: s.dim for n, s in params_shardings(model, _fake_mesh(1, 2)).items()
            if not s.replicated}, model


@pytest.mark.parametrize("heads", [(4, 4, 4, 4), (2, 2, 2, 2)])
def test_params_shardings_match_jax(heads):
    want = _jax_split(heads)
    got, model = _port_split(heads)
    assert set(got) <= set(want)
    assert all(got[n] == want[n] for n in got)
    replicated_here = sorted(set(want) - set(got))
    blocks = {n: m for n, m in model.named_modules() if type(m).__name__ == "CSWinBlock"}
    odd = sorted(n for b, blk in blocks.items() if blk.attns[0].num_heads % 2
                 for n, _ in model.named_parameters()
                 if n.startswith(b + ".") and n.endswith(ATTN))
    assert replicated_here == odd
    if heads == (4, 4, 4, 4):
        # 6 blocks of two branches (qkv 2, proj 1, fc 3, get_v 2 x 2), 2 of one
        assert not odd and len(got) == 6 * 10 + 2 * 8
    else:
        assert len(odd) == 6 * 7 and all("stage4" in n or "stage_up4" in n for n in got
                                         if n.endswith(ATTN))
    # the head-aligned shards: rank 1's qkv rows of a stage-2 block hold its
    # heads' channels of q, k and v within each branch
    s = params_shardings(model, _fake_mesh(1, 2))["stage2.0.qkv.weight"]
    if heads == (4, 4, 4, 4):
        C, cb = 32, 16
        own = [b * cb + c for b in range(2) for c in range(8, 16)]
        assert s.indices[1] == tuple(p * C + c for p in range(3) for c in own)
    else:
        assert s.replicated


def test_window_keep_mask_head_offset():
    heads, n, thr = 6, 9, dropout.u32_threshold(0.3)
    full = dropout.window_keep_mask(11, 8, heads, n, thr, nwin=4, win0=4, nwin_global=8)
    for h0, k in ((0, 3), (3, 3), (2, 2), (5, 1)):
        got = dropout.window_keep_mask(11, 8, k, n, thr, nwin=4, win0=4, nwin_global=8,
                                       head0=h0)
        assert torch.equal(got, full[:, h0:h0 + k])
    ar = torch.arange
    old = dropout.hash_keep_mask(11, ar(6)[:, None, None, None], ar(heads)[None, :, None, None],
                                 ar(n)[None, None, :, None], ar(n)[None, None, None, :], thr, n)
    assert torch.equal(dropout.window_keep_mask(11, 6, heads, n, thr, head0=0), old)
    assert dropout.kernel_drop_args(0.3, 11, head0=2) == (11, thr, 1.0 / 0.7, 0, 0, 2)
    assert dropout.kernel_drop_args(0.0, None, head0=2) == (0, 0, 1.0, 0, 0, 0)
    # the plain flash path: the heads of a call at head0 are those heads of the whole call
    rs = np.random.RandomState(2)
    qb, kb, vb = (torch.from_numpy(rs.randn(3, 40, 4 * 8).astype(np.float32)) for _ in range(3))
    kw = dict(attn_drop=0.3, seed=7)
    out, lse = flash_attention.flash_attention_reference(qb, kb, vb, heads=4, **kw)
    part = [t[..., 16:32] for t in (qb, kb, vb)]
    got, got_lse = flash_attention.flash_attention_reference(*part, heads=2, head0=2, **kw)
    torch.testing.assert_close(got, out[..., 16:32], rtol=0, atol=0)
    torch.testing.assert_close(got_lse, lse[..., 2:], rtol=0, atol=0)


def test_one_rank_model_axis_trains_as_one_process():
    """A (1, 1) mesh whose model axis splits every block (the shards are the
    whole tensors, the sums none): forward and a step at drops 0.3, bit for
    bit, through the blocks' tensor-parallel code."""
    images, masks = _disc_batch(np.random.RandomState(5))
    heads = dict(num_heads=(2, 4, 4, 4))
    results = []
    for mesh in (None, make_mesh((1, 1), ("data", "model"), device="cpu")):
        model = CSWinUNet(**TINY, **heads, use_simam=True, device="cpu", **DROPS)
        opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
        if mesh is not None:
            shardings = params_shardings(model, mesh)
            shard_state(model, opt, mesh, shardings)
            assert sum(not s.replicated for s in shardings.values()) == 6 * 10 + 2 * 8
            assert sum(b.tp is not None for b in model.modules()
                       if type(b).__name__ == "CSWinBlock") == 8
        step = engine.make_train_step(model, opt, mesh=mesh)
        metrics = step(images, masks, rng=3)
        state, moments = gather_state(model, opt, mesh) if mesh is not None else (
            model.state_dict(), {n: opt.state[p] for n, p in model.named_parameters()})
        results.append((metrics, state, moments))
    (m0, s0, o0), (m1, s1, o1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(s0[n], s1[n]) for n in s0)
    assert all(torch.equal(o0[n][k], o1[n][k]) for n in o0 for k in ("exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("case", ["mesh", "segmented", "rules", "twice"])
def test_tensor_parallel_refusals(case):
    model = CSWinUNet(**TINY, num_heads=(2, 4, 4, 4), use_simam=True, device="cpu")
    opt = engine.make_optimizer("adamw", 1e-3, 1e-4, model.parameters())
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    if case == "mesh":
        with pytest.raises(ValueError, match=r"needs 2 processes, have 1"):
            make_mesh((1, 2), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="the port's meshes are"):
            make_mesh((1, 1), ("model", "data"), device="cpu")
        with pytest.raises(ValueError, match="one size an axis"):
            make_mesh((1,), ("data", "model"), device="cpu")
    elif case == "segmented":
        with pytest.raises(ValueError, match=r"takes a \('data',\) mesh, as JAX's does"):
            make_segmented_train_step(model, opt, mesh=mesh)
    elif case == "rules":
        with pytest.raises(ValueError, match="splits a CSWin block's qkv, proj, get_v"):
            params_shardings(model, mesh, [Rule(r".*norm1\.weight$", 0, "model")])
        with pytest.raises(ValueError, match="splits a CSWin block's qkv, proj, get_v"):
            params_shardings(model, mesh, [Rule(r".*\.qkv\.weight$", 1, "model")])
        with pytest.raises(ValueError, match="over the 'model' axis"):
            params_shardings(model, mesh, [Rule(r".*\.qkv\.weight$", 0, "data")])
        part = params_shardings(model, mesh, partition_rules_cswin()[:1])
        with pytest.raises(ValueError, match="attention group .* must be split whole"):
            shard_state(model, opt, mesh, part)
    else:
        shard_state(model, opt, mesh, params_shardings(model, mesh))
        with pytest.raises(ValueError, match="the model is split already"):
            shard_state(model, opt, mesh)
        with pytest.raises(ValueError, match="already sharded"):
            params_shardings(model, mesh)
