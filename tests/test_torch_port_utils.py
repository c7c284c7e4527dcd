"""PyTorch port, ``utils/``: the throughput meter against JAX's, a trace
written on the CPU, the NaN and Inf checks, and ``start_profiler_server``
refused.  The card's side (device events in the trace) is ``chip_smoke.py``
phase 11."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from cswin_simam_unet_tpu.utils import profiling as jax_profiling

from cswin_simam_unet_tpu_torch.models import CSWinUNet
from cswin_simam_unet_tpu_torch.parallel import Mesh
from cswin_simam_unet_tpu_torch.utils import (ThroughputMeter, enable_debug_checks,
                                              start_profiler_server, trace)

TINY = dict(img_size=64, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2),
            num_heads=(2, 2, 4, 8))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_meter_matches_jax(monkeypatch):
    monkeypatch.setattr(ThroughputMeter, "elapsed", property(lambda self: 2.0))
    monkeypatch.setattr(jax_profiling.ThroughputMeter, "elapsed", property(lambda self: 2.0))
    ours, theirs = ThroughputMeter(n_chips=4), jax_profiling.ThroughputMeter(n_chips=4)
    for m in (ours, theirs):
        for batch in (8, 8, 5):
            m.update(batch)
    for name in ("steps_per_sec", "images_per_sec", "images_per_sec_per_chip"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.summary() == theirs.summary() == "1.50 steps/s, 10.5 img/s (2.6 img/s/chip)"
    ours.reset()
    assert ours.steps_per_sec == 0.0 and ours.images_per_sec == 0.0
    assert ThroughputMeter(mesh=Mesh(3, 0, torch.device("cpu"))).n_chips == 3
    assert ThroughputMeter().n_chips == max(torch.cuda.device_count(), 1)


def test_trace_writes_a_tensorboard_trace(tmp_path):
    model = CSWinUNet(**TINY, use_simam=True, device="cpu")
    with trace(str(tmp_path)) as prof:
        model(torch.rand(1, 64, 64, 3))
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert any(e.key.startswith("aten::") for e in prof.key_averages())


@pytest.mark.parametrize("where", ["forward NaN", "forward Inf", "backward NaN"])
def test_debug_checks_name_the_module(where):
    model = CSWinUNet(**TINY, use_simam=True, device="cpu")
    x = torch.rand(1, 64, 64, 3)
    anomaly = torch.is_anomaly_enabled()
    with enable_debug_checks(model, infs=where == "forward Inf"):
        assert torch.is_anomaly_enabled()
        model(x, train=True).sum().backward()  # finite: nothing raised
        if where.startswith("forward"):
            bad = x.clone()
            bad[0, 3, 5, 1] = float("nan" if "NaN" in where else "inf")
            with pytest.raises(FloatingPointError,
                               match=rf"{where.split()[1]} in the forward: an output of "
                                     r"module 'stage1_conv_embed.0' \(Conv2d\)"):
                model(bad)
        else:
            with pytest.raises(FloatingPointError,
                               match="NaN in the backward: the gradient of an output of "
                                     "module 'CSWinUNet'"):
                (model(x, train=True) * float("nan")).sum().backward()
    assert torch.is_anomaly_enabled() == anomaly
    out = model(torch.full((1, 64, 64, 3), float("inf")))  # the hooks are gone
    assert not np.isfinite(out.detach().numpy()).all()


def test_start_profiler_server_is_refused():
    with pytest.raises(NotImplementedError, match="live-attach xprof server"):
        start_profiler_server(9999)
