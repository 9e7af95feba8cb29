"""Evaluation CLI (counterpart of toothgroupnetwork_tpu/cli/evaluate.py, the
same arguments and printed lines): compare prediction JSON(s) against the
ground truth, print IoU / F1(TSA) / ACC / SEM_ACC(TIR).

    python -m toothgroupnetwork_tpu_torch.cli.evaluate \\
        --gt_json_path jsons --pred_json_path predictions
"""

import argparse
import json
import os
from glob import glob

import numpy as np

from ..eval.metrics import cal_metric


def _load_labels(path):
    with open(path) as f:
        return np.array(json.load(f)["labels"]).reshape(-1)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate challenge JSON predictions")
    parser.add_argument("--gt_json_path", required=True,
                        help="a GT json file, or a dir of them")
    parser.add_argument("--pred_json_path", required=True,
                        help="matching prediction json file or dir")
    parser.add_argument("--half_arch_tolerance", action="store_true")
    args = parser.parse_args(argv)

    if os.path.isdir(args.pred_json_path):
        pred_paths = sorted(glob(os.path.join(args.pred_json_path, "*.json")))
        pairs = []
        for p in pred_paths:
            base = os.path.basename(p)
            matches = glob(os.path.join(args.gt_json_path, "**", base),
                           recursive=True)
            if matches:
                pairs.append((matches[0], p))
    else:
        pairs = [(args.gt_json_path, args.pred_json_path)]

    agg = np.zeros(4)
    for gt_path, pred_path in pairs:
        gt = _load_labels(gt_path)
        pred = _load_labels(pred_path)
        iou, f1, acc, sem_acc, _ = cal_metric(gt, pred, pred,
                                              is_half=args.half_arch_tolerance)
        agg += (iou, f1, acc, sem_acc)
        print(f"{os.path.basename(pred_path)}: IoU {iou:.4f} F1(TSA) {f1:.4f} "
              f"ACC {acc:.4f} SEM_ACC(TIR) {sem_acc:.4f}")
    if len(pairs) > 1:
        iou, f1, acc, sem_acc = agg / len(pairs)
        print(f"MEAN over {len(pairs)}: IoU {iou:.4f} F1(TSA) {f1:.4f} "
              f"ACC {acc:.4f} SEM_ACC(TIR) {sem_acc:.4f}")


if __name__ == "__main__":
    main()
