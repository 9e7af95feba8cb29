"""Checkpoints (counterpart of toothgroupnetwork_tpu/train/checkpoints.py).

The resumable state goes into one ``torch.save`` file a slot, in the JAX
package's two slots (``<ckpt>`` the latest, ``<ckpt>_val`` the best
validation): the model's parameters and BatchNorm statistics, the
optimizer's state and the step count, with ``<slot>.meta.json`` holding the
epoch (and ``best_val``). The weights alone export to the JAX package's
``.npz`` layout (``utils/weights.save_npz``), which its ``load_weights`` and
the port's ``load_npz`` both read.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from ..utils.weights import save_npz


def save_train_checkpoint(path: str, model: nn.Module,
                          optimizer: torch.optim.Optimizer, step: int, epoch: int,
                          extra: dict | None = None) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": int(step)}, path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"epoch": int(epoch), **(extra or {})}, f)


def restore_train_checkpoint(path: str, model: nn.Module,
                             optimizer: torch.optim.Optimizer) -> tuple[int, int]:
    """Load a slot into ``model`` and ``optimizer`` (on the model's device);
    returns (step, epoch)."""
    path = os.path.abspath(path)
    device = next(model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(payload["model"])
    optimizer.load_state_dict(payload["optimizer"])
    epoch = 0
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            epoch = json.load(f).get("epoch", 0)
    return int(payload["step"]), epoch


def save_weights(path: str, model: nn.Module) -> None:
    """Weights-only export in the JAX package's ``.npz`` layout."""
    save_npz(path, model)
