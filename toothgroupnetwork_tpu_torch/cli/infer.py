"""Inference CLI: walk a directory of scans, run the pipeline on ``--device``,
write one challenge JSON per scan (counterpart of
toothgroupnetwork_tpu/cli/infer.py). ``--model_name`` is any of the six
names ``make_inference_pipeline`` takes: tgnet (two checkpoints), pointnet,
pointnetpp, dgcnn, pointtransformer or tsegnet (one).

    python -m toothgroupnetwork_tpu_torch.cli.infer --input_dir_path scans \\
        --save_path out --model_name tgnet --checkpoint_path fps.npz \\
        --checkpoint_path_bdl bdl.npz
    python -m toothgroupnetwork_tpu_torch.cli.infer --input_dir_path scans \\
        --save_path out --model_name dgcnn --checkpoint_path dgcnn.npz
"""

import argparse
import json
import os
from glob import glob

from ..pipelines import ScanSegmentation, make_inference_pipeline
from ..utils.device import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run inference to challenge JSON")
    parser.add_argument("--input_dir_path", required=True,
                        help="dir (or dir of dirs) containing .obj scans")
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--model_name", required=True)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--checkpoint_path_bdl", default=None,
                        help="second-stage checkpoint (tgnet)")
    parser.add_argument("--config_path", default=None,
                        help="config json whose model_parameter the checkpoint "
                             "was trained with (defaults to the preset)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    config = None
    if args.config_path:
        with open(args.config_path) as f:
            config = {"model_parameter": json.load(f)["model_parameter"]}
    ckpts = [args.checkpoint_path]
    if args.checkpoint_path_bdl:
        ckpts.append(args.checkpoint_path_bdl)
    pipeline = make_inference_pipeline(args.model_name, ckpts, config,
                                       device=device)
    pred_obj = ScanSegmentation(pipeline)

    stl_paths = sorted(glob(os.path.join(args.input_dir_path, "**", "*.obj"),
                            recursive=True))
    os.makedirs(args.save_path, exist_ok=True)
    for i, stl_path in enumerate(stl_paths):
        out = os.path.join(args.save_path,
                           os.path.basename(stl_path).replace(".obj", ".json"))
        print(f"[{i + 1}/{len(stl_paths)}] {stl_path} -> {out}")
        pred_obj.process(stl_path, out)
    return pipeline


if __name__ == "__main__":
    main()
