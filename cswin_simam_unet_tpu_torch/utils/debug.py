"""NaN and Inf checks: ``enable_debug_checks``.

Counterpart of ``cswin_simam_unet_tpu/utils/debug.py``, where JAX turns on
``jax_debug_nans`` / ``jax_debug_infs`` for every jitted program.  Here a
forward hook on each submodule of the model checks the module's outputs,
and a hook on each of those outputs checks the gradient that reaches it in
the backward: the first that holds a NaN (or an Inf, with ``infs``) raises
``FloatingPointError`` naming the module.  Autograd's anomaly mode is on
meanwhile, so that an error in the backward also prints the traceback of
the forward call that made the failing node; its own NaN check is left
off, since it names an autograd function rather than a module.  Every
check waits for the device: a debugging mode, never one to time.
"""

from __future__ import annotations

import torch


class DebugChecks:
    """The hooks of :func:`enable_debug_checks`; ``remove()`` (or leaving
    it as a context manager) takes them away and restores anomaly mode."""

    def __init__(self, model: torch.nn.Module, nans: bool, infs: bool):
        self._nans, self._infs = nans, infs
        self._anomaly = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
        self._handles = [module.register_forward_hook(self._hook(name or type(model).__name__))
                         for name, module in model.named_modules()]
        torch.autograd.set_detect_anomaly(True, check_nan=False)

    def _bad(self, t: torch.Tensor) -> str:
        if not t.is_floating_point():
            return ""
        if self._nans and bool(torch.isnan(t).any()):
            return "NaN"
        if self._infs and bool(torch.isinf(t).any()):
            return "Inf"
        return ""

    def _hook(self, name: str):
        def on_grad(g):
            bad = self._bad(g)
            if bad:
                raise FloatingPointError(f"{bad} in the backward: the gradient of an output "
                                         f"of module '{name}'")

        def hook(module, args, output):
            outs = output.values() if isinstance(output, dict) else (
                output if isinstance(output, (tuple, list)) else (output,))
            for t in outs:
                if not isinstance(t, torch.Tensor):
                    continue
                bad = self._bad(t)
                if bad:
                    raise FloatingPointError(f"{bad} in the forward: an output of module "
                                             f"'{name}' ({type(module).__name__})")
                if t.requires_grad:
                    t.register_hook(on_grad)
        return hook

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
        torch.autograd.set_detect_anomaly(*self._anomaly)

    def __enter__(self) -> "DebugChecks":
        return self

    def __exit__(self, *exc) -> None:
        self.remove()


def enable_debug_checks(model: torch.nn.Module, nans: bool = True,
                        infs: bool = False) -> DebugChecks:
    """Raise ``FloatingPointError`` at the first output of a module of
    ``model`` (itself included), in the forward, or at the first gradient
    of such an output in the backward, that holds a NaN (``nans``) or an
    Inf (``infs``), naming the module.  JAX's checks are global; torch's
    hooks attach to a model, so it is given.  Returns the hooks' handle."""
    return DebugChecks(model, nans, infs)
