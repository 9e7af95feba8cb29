"""Model registry: name -> ModelTask (counterpart of
toothgroupnetwork_tpu/models/registry.py): a module constructor, the loss
computation, the preset config and an optional host stage, consumed by the
Trainer."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

# compute_losses(outputs, batch, config) -> {name: (value, weight)}
LossFn = Callable[[dict, dict, Any], dict]


@dataclass
class ModelTask:
    name: str
    # build_module(config, device=...) -> nn.Module
    build_module: Callable[..., Any]
    compute_losses: LossFn
    default_config: Callable[[], Any]
    # extra forward kwargs drawn from the batch (tgnet crops around the
    # ground-truth centroids, so it needs the labels): batch -> kwargs
    forward_kwargs: Callable[[dict], dict] = field(default=lambda batch: {})
    # optional host stage run before each step on the loader's numpy batch
    # (its mesh_path and augmenter fields too), returning arrays that
    # replace or join the batch's: (model, batch, config, step) -> dict,
    # ``step`` the optimizer steps taken (JAX's state.step). tgnet_bdl
    # boundary-resamples each scan around a frozen fps model
    # (train/bdl_engine.py); tsegnet proposes its crops by DBSCAN over its
    # own centroid predictions
    host_stage: Callable | None = field(default=None)


_REGISTRY: dict[str, ModelTask] = {}


def register_task(task: ModelTask) -> ModelTask:
    _REGISTRY[task.name] = task
    return task


def get_task(name: str) -> ModelTask:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_models() -> list[str]:
    return sorted(_REGISTRY)
