"""tgnet model presets (counterpart of the tgnet parts of
toothgroupnetwork_tpu/models/tasks.py). Configs are plain dicts: the JAX
package's TrainConfig cannot be imported without JAX."""

from __future__ import annotations

import copy

import torch

from .tgnet import TGNet

# model_parameter["dtype"] -> the backbone's compute dtype (tasks.py:
# _pt_backbone_params); parameters, geometry and logits stay float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# train_configs/tgnet_fps.py model_parameter (tasks.py:_tgnet_preset)
TGNET_FPS_MODEL_PARAMETER = {
    "input_feat": 6,
    "stride": [1, 4, 4, 4, 4],
    "nsample": [36, 24, 24, 24, 24],
    "blocks": [2, 3, 4, 6, 3],
    "block_num": 5,
    "planes": [32, 64, 128, 256, 512],
    "crop_sample_size": 3072,
}

# the boundary model's arch (train_configs/tgnet_bdl.py, pipelines/tgn.py)
TGNET_BDL_ARCH = dict(planes=(16, 32), stride=(1, 1), nsample=(36, 24),
                      blocks=(2, 3), block_num=2)


def tgnet_fps_config() -> dict:
    return {"model_name": "tgnet_fps",
            "model_parameter": copy.deepcopy(TGNET_FPS_MODEL_PARAMETER)}


def backbone_kwargs(mp: dict) -> dict:
    """model_parameter -> backbone kwargs (tasks.py:_pt_backbone_params)."""
    return dict(
        c=mp.get("input_feat", 6),
        planes=tuple(mp.get("planes", (32, 64, 128, 256, 512))),
        stride=tuple(mp.get("stride", (1, 4, 4, 4, 4))),
        nsample=tuple(mp.get("nsample", (36, 24, 24, 24, 24))),
        blocks=tuple(mp.get("blocks", (2, 3, 4, 6, 3))),
        block_num=mp.get("block_num", 5),
    )


def build_tgnet_fps(cfg: dict, *, device) -> TGNet:
    mp = cfg["model_parameter"]
    name = mp.get("dtype", "float32")
    if name not in DTYPES:
        raise NotImplementedError(f"model_parameter dtype {name!r}: the port "
                                  f"serves {sorted(DTYPES)}")
    return TGNet(crop_size=mp.get("crop_sample_size", 3072),
                 cell_attention=bool(mp.get("cell_attention", False)),
                 **backbone_kwargs(mp), device=device, dtype=DTYPES[name])


def build_tgnet_bdl(crop_size: int, arch: dict | None = None, *, device) -> TGNet:
    """The boundary model: built without the dtype, so float32 (as in the
    JAX pipeline, only the fps model takes ``model_parameter["dtype"]``)."""
    return TGNet(crop_size=crop_size, c=6, **dict(arch or TGNET_BDL_ARCH),
                 device=device)
