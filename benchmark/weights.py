"""Seeded random weights, drawn on the device in two calls and written in
the JAX package's ``.npz`` layout (``params/<path>/kernel`` ``[in, out]``
for a Dense weight, ``batch_stats/<path>/mean|var``), the format the
program's pipelines load and the reference reads.

Dense weights ~ N(0, 1 / fan_in); BatchNorm scales ~ 1 + N(0, 0.01),
biases and running means ~ N(0, 0.01), running variances in [0.5, 1.5).
"""

from __future__ import annotations

import numpy as np
import torch

SCALE = 0.1


def draw(shapes: dict, device, seed: int) -> dict:
    """``name -> tensor`` for the ``state_dict``-style names and shapes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        n, u = normal[at:at + size].view(shape), uniform[at:at + size].view(shape)
        at += size
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight":
            out[name] = n / shape[1] ** 0.5
        elif leaf == "var":
            out[name] = 0.5 + u
        elif leaf == "scale":
            out[name] = 1.0 + SCALE * n
        else:
            out[name] = SCALE * n
    return out


def save_npz(path, tensors: dict, buffers: set) -> None:
    flat = {}
    for name, t in tensors.items():
        parts = name.split(".")
        arr = t.detach().float().cpu().numpy()
        if parts[-1] == "weight":
            parts[-1], arr = "kernel", arr.T
        group = "batch_stats" if name in buffers else "params"
        flat[group + "/" + "/".join(parts)] = np.ascontiguousarray(arr)
    np.savez(path, **flat)
