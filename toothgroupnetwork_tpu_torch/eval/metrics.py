"""Challenge metrics (counterpart of toothgroupnetwork_tpu/eval/metrics.py,
the same arithmetic): per predicted instance, majority-vote GT label
matching -> TP/FP/FN -> per-instance IoU, F1 (= the challenge's "TSA"), ACC
and SEM_ACC (= "TIR", majority semantic label match, optionally half-arch
tolerant), averaged over the predicted instances. Instance id 0
(gingiva/background) is excluded.
"""

from __future__ import annotations

import numpy as np


def cal_metric(gt_labels, pred_sem_labels, pred_ins_labels, is_half: bool = False):
    """Returns ``(IoU, F1, ACC, SEM_ACC, IoU_per_instance)``.

    Args:
      gt_labels: ``[N]`` ground-truth labels (FDI numbers in the challenge contract).
      pred_sem_labels: ``[N]`` predicted semantic labels.
      pred_ins_labels: ``[N]`` predicted instance ids (0 = background).
      is_half: SEM_ACC also accepts ``sem + 8 == gt`` (half-arch tolerance).
    """
    gt_labels = np.asarray(gt_labels).reshape(-1)
    pred_sem_labels = np.asarray(pred_sem_labels).reshape(-1)
    pred_ins_labels = np.asarray(pred_ins_labels).reshape(-1)

    ins_names = np.unique(pred_ins_labels)
    ins_names = ins_names[ins_names != 0]
    if len(ins_names) == 0:
        return 0.0, 0.0, 0.0, 0.0, []

    iou_sum = f1_sum = acc_sum = sem_acc_sum = 0.0
    iou_arr = []
    for ins_name in ins_names:
        ins_mask = pred_ins_labels == int(ins_name)
        gt_uniq, gt_counts = np.unique(gt_labels[ins_mask], return_counts=True)
        gt_name = gt_uniq[np.argmax(gt_counts)]
        gt_mask = gt_labels == gt_name

        tp = np.count_nonzero(gt_mask & ins_mask)
        fn = np.count_nonzero(gt_mask & ~ins_mask)
        fp = np.count_nonzero(~gt_mask & ins_mask)
        tn = np.count_nonzero(~gt_mask & ~ins_mask)

        acc_sum += (tp + tn) / (fp + tp + fn + tn)
        precision = tp / (tp + fp)
        recall = tp / (tp + fn) if (tp + fn) else 0.0
        f1_sum += (2 * precision * recall / (precision + recall)
                   if (precision + recall) else 0.0)
        iou = tp / (fp + tp + fn)
        iou_sum += iou
        iou_arr.append(iou)

        sem_uniq, sem_counts = np.unique(pred_sem_labels[ins_mask], return_counts=True)
        sem_name = sem_uniq[np.argmax(sem_counts)]
        if is_half:
            if sem_name == gt_name or sem_name + 8 == gt_name:
                sem_acc_sum += 1
        elif sem_name == gt_name:
            sem_acc_sum += 1

    n = len(ins_names)
    return iou_sum / n, f1_sum / n, acc_sum / n, sem_acc_sum / n, iou_arr
