"""Overlapped serving of the PyTorch port on one card, alone.

    python3 tools/torch_serve_many.py

Runs ``chip_smoke.py``'s serve-many phase (``phase_serve_many``) on
pipelines made afresh from random full-width weights: six synthetic
100489-vertex scans (seeds 0-5) served serially and through
``TgnInferencePipeline.run_many`` in the default configuration, three of
them in the cell-attention and bfloat16 configurations, each checked
identical to serial with equal launch counts, with scans per second and the
phases' seconds a scan both ways, the busy share of one profiled batch and
the default batch with 1, 2 and 4 scans in flight. Every line carries the
card's nvidia-smi name and power limit. Needs one CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serve_many: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from toothgroupnetwork_tpu_torch.models.tasks import tgnet_fps_config
    from toothgroupnetwork_tpu_torch.ops.kernels import (attention, build,
                                                         cell_select, fps, gather,
                                                         knn)
    from toothgroupnetwork_tpu_torch.pipelines.tgn import (TgnInferencePipeline,
                                                           use_full_fp32)

    use_full_fp32()
    chip_smoke.CARD["card"] = chip_smoke.smi_line()
    build.library()
    chip_smoke.log("build", **build.build_info)
    kernels = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x,
               attention.project_kv, cell_select.cell_select_x,
               cell_select.cell_select_p, attention.fused_vector_attention,
               attention.fused_vector_attention_packed, gather.onehot_gather_packed)
    with tempfile.TemporaryDirectory(prefix="serve_many_") as tmp:
        work = Path(tmp)
        ckpts = chip_smoke.make_weights(work)
        pipes = {}
        for name, params in (("default", {}), ("cell", {"cell_attention": True}),
                             ("bf16", {"dtype": "bfloat16"})):
            cfg = tgnet_fps_config()
            cfg["model_parameter"].update(params)
            pipes[name] = TgnInferencePipeline(str(ckpts["fps"]), str(ckpts["bdl"]),
                                               cfg, device=chip_smoke.card())
        chip_smoke.phase_serve_many(pipes, work, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
