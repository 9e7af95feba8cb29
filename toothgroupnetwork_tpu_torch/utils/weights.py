"""Weight bridge: the flax ``.npz`` checkpoints of the JAX package
(toothgroupnetwork_tpu/train/checkpoints.py:save_weights) <-> torch modules.

The ``.npz`` holds flattened leaves keyed ``params/<path>/<leaf>`` and
``batch_stats/<path>/<leaf>``. The port's submodule names ARE the flax module
names, so the map is mechanical: ``/`` becomes ``.``; a Dense ``kernel``
``[in, out]`` becomes ``nn.Linear.weight`` ``[out, in]``; ``bias`` and the
BatchNorm ``scale``/``mean``/``var`` keep their names.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn


def from_jax_variables(flat: dict) -> dict[str, torch.Tensor]:
    """Flattened flax variables (``save_weights`` keys) -> torch state_dict."""
    state = {}
    for key, value in flat.items():
        collection, _, path = key.partition("/")
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected collection in {key!r}")
        parts = path.split("/")
        arr = np.asarray(value, dtype=np.float32)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            arr = arr.T
        state[".".join(parts)] = torch.from_numpy(np.array(arr, order="C"))
    return state


def to_jax_variables(module: nn.Module) -> dict[str, np.ndarray]:
    """Inverse of :func:`from_jax_variables` for a port module."""
    buffers = {name for name, _ in module.named_buffers()}
    flat = {}
    for name, value in module.state_dict().items():
        parts = name.split(".")
        arr = value.detach().cpu().numpy().astype(np.float32)
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            arr = arr.T
        collection = "batch_stats" if name in buffers else "params"
        flat[collection + "/" + "/".join(parts)] = np.ascontiguousarray(arr)
    return flat


def load_npz(path: str, module: nn.Module) -> nn.Module:
    """Load a JAX-package weights ``.npz`` into ``module`` (strict: every key
    of the module must be present with its shape)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        state = from_jax_variables({k: data[k] for k in data.files})
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f"checkpoint {path!r} lacks {missing[:5]} "
                       f"({len(missing)} keys)")
    for k, v in own.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {k}: {tuple(state[k].shape)} "
                             f"vs {tuple(v.shape)}")
    module.load_state_dict({k: state[k] for k in own})
    return module


def save_npz(path: str, module: nn.Module) -> None:
    """Write ``module`` in the JAX package's ``.npz`` layout, without JAX."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **to_jax_variables(module))


def randomize_(module: nn.Module, generator: torch.Generator,
               scale: float = 0.1) -> nn.Module:
    """Random weights from ``generator`` for runs without a trained checkpoint:
    Linear weights ~ N(0, 1/fan_in), BatchNorm scales ~ 1 + N(0, scale^2),
    biases and running means ~ N(0, scale^2), running variances in [0.5, 1.5)."""
    with torch.no_grad():
        for name, t in module.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "var":
                r = 0.5 + torch.rand(t.shape, generator=generator)
            elif leaf == "weight":
                r = torch.randn(t.shape, generator=generator) / t.shape[1] ** 0.5
            elif leaf == "scale":
                r = 1.0 + scale * torch.randn(t.shape, generator=generator)
            else:
                r = scale * torch.randn(t.shape, generator=generator)
            t.copy_(r.to(t.device))
    return module


# flax's lecun_normal: a standard normal truncated to [-2, 2], divided by
# its standard deviation (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def init_like_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``module`` from flax's initialisers, drawn from
    ``generator``: every Dense weight ``lecun_normal`` (variance 1 / fan_in,
    truncated normal) but zero where the layer is marked ``zero_init`` (the
    flax module's ``kernel_init=zeros``: no draw), Dense biases zero,
    BatchNorm scale 1, bias 0, mean 0 and variance 1, LayerNorm scale 1 and
    bias 0. The weights are drawn in module order."""
    from ..nn.layers import LayerNorm, MaskedBatchNorm

    lo, hi = ((1.0 + math.erf(s / math.sqrt(2.0))) / 2.0 for s in (-2.0, 2.0))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                if getattr(m, "zero_init", False):
                    m.weight.zero_()
                else:
                    fan_in = m.weight.shape[1]
                    u = torch.rand(m.weight.shape, generator=generator,
                                   dtype=torch.float64)
                    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
                    z = z.clamp(-2.0, 2.0) * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)
                    m.weight.copy_(z.to(m.weight.device, m.weight.dtype))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MaskedBatchNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
            elif isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
    return module
