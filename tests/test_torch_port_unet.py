"""PyTorch port, the UNet family: the model, its weights and serving.

Against the JAX package on the CPU in float32 with the same numpy inputs
and weights (every JAX call jitted), at JAX's own test width
(``base_features=4``) on 32^2 images: the eval forward's logits on running
statistics, ``predict``, and the training forward's logits and moved
running statistics (biased variance, momentum 0.1) within 2e-4 x max(1,
max|JAX|), at 1 and 4 classes with SimAM on and off, and the same in bf16
against JAX's bf16 UNet (statistics float32 in both, ``TOL_BF16_*``);
``unet_state_dict`` equal to JAX's ``export_unet_variables`` name for name
and value for value, and such a reference-named ``.pth`` loading strictly;
the full-width model's 31,043,521 parameters under JAX's exported names and
shapes (no forward); ``Server``'s padded buckets against ``predict``; the
three UNet configs against JAX's.  One test keeps the trap in sight:
``F.batch_norm``'s running variance (unbiased) is not JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp

from cswin_simam_unet_tpu import configs as jax_configs
from cswin_simam_unet_tpu.compat.torch_export import export_unet_variables
from cswin_simam_unet_tpu.models import UNet as JaxUNet

from cswin_simam_unet_tpu_torch import configs
from cswin_simam_unet_tpu_torch.compat import load_flax_params, unet_state_dict
from cswin_simam_unet_tpu_torch.compat.io import load_state_dict_file, load_state_dict_strict
from cswin_simam_unet_tpu_torch.models import BatchNorm, UNet
from cswin_simam_unet_tpu_torch.serving import Server
from cswin_simam_unet_tpu_torch.train.checkpoint import save_weights

TOL_MODEL = 2e-4  # float32 model parity, x max(1, max|JAX|)
# bf16 against JAX's bf16 UNet: the logits in relative norm (largest of the
# four forward cases: 0.017 eval, 0.036 training), the running statistics
# (float32 in both) x max(1, max|JAX|) (largest 0.0028); the two round at
# different points, and each lies as far from its float32 model
TOL_BF16_NORM = 0.1
TOL_BF16_STATS = 1e-2
BASE = 4          # JAX's test width (tests/test_engine.py)
IMG = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's small CPU ops (the test workers
    share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL_MODEL, name=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def _rel(got, want):
    got = np.asarray(got.detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def jax_unet_variables(jm, rs, img=IMG):
    """Flax UNet variables from a numpy seed (traced, not compiled): conv
    kernels normal(1/sqrt(fan_in)), scales 1 + 0.1 noise, biases 0.05
    noise (conv biases too: then L2 decay, not rounding, sets their Adam
    step, which BatchNorm's mean subtraction leaves without a loss
    gradient), running means 0.1 noise and running variances in
    [0.5, 1.5]."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "var" in name:
            return (0.5 + rs.rand(*leaf.shape)).astype(np.float32)
        noise = rs.randn(*leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * noise
        if "bias" in name or "mean" in name:
            return (0.05 if "bias" in name else 0.1) * noise
        return (noise / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_unet(variables, n_classes=1, use_simam=False, dtype=torch.float32):
    model = UNet(n_classes=n_classes, base_features=BASE, use_simam=use_simam, device="cpu",
                 dtype=dtype)
    load_flax_params(model, variables)
    return model


def _images(rs, n=2, img=IMG):
    return rs.rand(n, img, img, 3).astype(np.float32)


@pytest.mark.parametrize("n_classes,use_simam", [(1, False), (1, True), (4, False), (4, True)])
def test_forward_matches_jax(n_classes, use_simam):
    """Eval logits on the running statistics, ``predict``, then a training
    forward's logits and the running statistics it leaves; in float32, then
    in bf16 with float32 statistics and gradients."""
    rs = np.random.RandomState(10 * n_classes + use_simam)
    jm = JaxUNet(n_classes=n_classes, base_features=BASE, use_simam=use_simam)
    variables = jax_unet_variables(jm, rs)
    x = _images(rs)
    port = port_unet(variables, n_classes, use_simam)
    xt = torch.from_numpy(x)

    _close(port(xt), jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x), name="eval")
    _close(port.predict(xt), jax.jit(jm.predict)(variables, x), name="predict")
    assert tuple(port(xt).shape) == (2, IMG, IMG, n_classes)

    logits, updates = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, x)
    _close(port(xt, train=True), logits, name="train")
    want = unet_state_dict({"params": variables["params"], "batch_stats": updates["batch_stats"]})
    buffers = dict(port.named_buffers())
    for name, b in buffers.items():
        if name.endswith(("running_mean", "running_var")):
            _close(b, want[name], name=name)
        else:
            assert int(b) == 1, name  # one training forward counted

    # bf16 (``--bf16``): the same weights against JAX's bf16 UNet, whose
    # running statistics stay float32 as the port's do
    j16 = JaxUNet(n_classes=n_classes, base_features=BASE, use_simam=use_simam,
                  dtype=jnp.bfloat16)
    port = port_unet(variables, n_classes, use_simam, torch.bfloat16)
    got = port(xt)
    assert got.dtype == torch.bfloat16
    want = jax.jit(lambda v, a: j16.apply(v, a, train=False))(variables, x)
    assert _rel(got, want) <= TOL_BF16_NORM, "bf16 eval"
    logits, updates = jax.jit(lambda v, a: j16.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, x)
    got = port(xt, train=True)
    assert _rel(got, logits) <= TOL_BF16_NORM, "bf16 train"
    want = unet_state_dict({"params": variables["params"], "batch_stats": updates["batch_stats"]})
    for name, b in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert b.dtype == torch.float32, name
            _close(b, want[name], TOL_BF16_STATS, f"bf16 {name}")
    got.float().sum().backward()
    for name, p in port.named_parameters():
        assert p.grad.dtype == torch.float32 and bool(p.grad.isfinite().all()), name


def test_batchnorm_running_variance_is_biased_as_in_jax():
    """The trap: ``F.batch_norm`` (``nn.BatchNorm2d``) moves its running
    variance with the unbiased batch variance, n/(n-1) times flax's biased
    one, so it would not match JAX; the port's ``BatchNorm`` does."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 4, 5).astype(np.float32) * 2 + 1  # n = 2*3*4 = 24 per channel
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    y, updates = bn.apply(variables, x, mutable=["batch_stats"])
    want_mean = np.asarray(updates["batch_stats"]["mean"])
    want_var = np.asarray(updates["batch_stats"]["var"])

    port = BatchNorm(5)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)  # NCHW, as in the model
    _close(got.permute(0, 2, 3, 1), y, 2e-5, "output")
    _close(port.running_mean, want_mean, 2e-5, "running_mean")
    _close(port.running_var, want_var, 2e-5, "running_var")

    rm, rv = torch.zeros(5), torch.ones(5)
    F.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), rm, rv, training=True, momentum=0.1,
                 eps=1e-5)
    _close(rm, want_mean, 2e-5, "torch's running_mean")
    n = 24
    torch_var_step = (rv.numpy() - 0.9) / 0.1
    jax_var_step = (want_var - 0.9) / 0.1
    np.testing.assert_allclose(torch_var_step, jax_var_step * n / (n - 1), rtol=1e-4)
    assert np.abs(rv.numpy() - want_var).max() > 100 * 2e-5  # torch's would not match JAX


def test_full_width_model_has_the_reference_parameters():
    """``build_model("unet")``: 31,043,521 parameters, every name and shape
    (buffers included) those of JAX's exporter at full width (no forward)."""
    model = configs.build_model("unet", device="cpu")
    assert isinstance(model, UNet) and model.supports_flat_logits is False
    assert sum(p.numel() for p in model.parameters()) == 31_043_521
    shapes = jax.eval_shape(JaxUNet(use_simam=True).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMG, IMG, 3)))
    exported = export_unet_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    own = model.state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in exported.items()}
    for name, b in model.named_buffers():
        want = 1.0 if name.endswith("running_var") else 0.0
        assert bool((b == want).all()), name


def test_unet_state_dict_equals_jax_exporter(tmp_path):
    """Name for name and value for value (the transpose convs flipped), and
    the files: JAX's exported dict as a reference-named ``.pth`` and the
    port's own weights file both load strictly and run as JAX does."""
    rs = np.random.RandomState(5)
    jm = JaxUNet(n_classes=2, base_features=BASE, use_simam=True)
    variables = jax_unet_variables(jm, rs)
    got, want = unet_state_dict(variables), export_unet_variables(variables)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert not np.array_equal(got["up1.up.weight"],
                              np.transpose(variables["params"]["up1"]["up"]["kernel"],
                                           (2, 3, 0, 1)))

    path = str(tmp_path / "reference.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in want.items()}, path)
    model = UNet(n_classes=2, base_features=BASE, use_simam=True, device="cpu", seed=9)
    load_state_dict_strict(model, load_state_dict_file(path), source=path)
    x = _images(rs, 1)
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x)
    _close(model(torch.from_numpy(x)), ref, name="from the .pth")
    own = str(tmp_path / "own.pth")
    save_weights(own, model)
    again = UNet(n_classes=2, base_features=BASE, use_simam=True, device="cpu", seed=4)
    load_state_dict_strict(again, load_state_dict_file(own), source=own)
    for (name, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="missing .*--config"):
        load_state_dict_strict(UNet(n_classes=2, base_features=BASE, device="cpu"),
                               {k: v for k, v in again.state_dict().items()
                                if not k.startswith("outc")})


def test_server_pads_like_predict():
    """Requests of 1, 3 and 11 images at the buckets 1/2/4/8 (zero padding,
    chunks of 8) give ``predict``'s and JAX's probabilities."""
    rs = np.random.RandomState(6)
    jm = JaxUNet(base_features=BASE, use_simam=True)
    variables = jax_unet_variables(jm, rs)
    port = port_unet(variables, use_simam=True)
    server = Server(port)
    images = (rs.rand(11, IMG, IMG, 3) * 255).astype(np.uint8)
    want = jax.jit(jm.predict)(variables, images.astype(np.float32) / 255.0)
    for n in (1, 3, 11):
        got = server(images[:n])
        assert tuple(got.shape) == (n, IMG, IMG, 1)
        _close(got, np.asarray(want)[:n], name=f"request of {n}")
        torch.testing.assert_close(got, port.predict(torch.from_numpy(images[:n]).float() / 255.0),
                                   rtol=0, atol=1e-6)
    assert [server.bucket(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]


def test_unet_configs_match_jax():
    """The model's and the run's fields of JAX's three UNet entries; the
    family builds a ``UNet``; overrides work as for the CSWin configs."""
    for name in ("unet", "unet_256", "unet_simam_256"):
        ours, theirs = configs.get_config(name), jax_configs.get_config(name)
        m, jm = ours.model, theirs.model
        assert (m.family, ours.image_size, m.num_classes, m.in_chans, m.use_simam, m.dtype) == (
            jm.family, theirs.image_size, jm.n_classes, jm.in_channels, jm.use_simam, jm.dtype)
        for f in ("batch_size", "optimizer", "learning_rate", "weight_decay", "num_epochs",
                  "plateau_factor", "plateau_patience", "plateau_min_lr", "test_split", "seed",
                  "num_workers", "grad_accum", "checkpoint_dir", "output_prefix"):
            assert getattr(ours.train, f) == getattr(theirs, f), (name, f)
        assert dataclasses.asdict(ours.train.augment) == dataclasses.asdict(theirs.augment)
        over = configs.get_config(name, image_size=64, model_num_classes=3,
                                  model_dtype="bfloat16", model_use_simam=not m.use_simam)
        model = configs.build_model(over.model, device="cpu")
        assert isinstance(model, UNet) and model.dtype == torch.bfloat16
        assert model.num_classes == 3 and model.inc.use_simam == (not m.use_simam)
        with pytest.raises(ValueError, match="divisible by 16"):
            configs.build_model(name, device="cpu", img_size=72)
