"""Dataset + host batching pipeline (the dataset, collation and loader of
toothgroupnetwork_tpu/data/dataset.py, held bit-equal to them by the tests,
and its split-file maker, which the split CLI calls).

Replaces the reference's ``DentalModelGenerator`` torch Dataset (reference:
generator.py:10-71) and the DataLoader/collate in runner.py:7-50. Contracts preserved:
  * glob ``*_sampled_points.npy`` under the data dir (generator.py:13),
  * optional split filtering by case id = basename up to the first ``_``
    (generator.py:15-29),
  * features = columns 0:6 as float32 ``[N, 6]``; labels = column 6 as int − 1, so
    −1 = gingiva and 0..15 = teeth (generator.py:40-47),
  * per-item augmentation with freshly drawn parameters (generator.py:49-58); the
    augmentation object travels with the item so the BDL stage can re-apply it.

Differences from the reference: channel-LAST ``[N, 6]`` layout (the reference permutes
to ``[6, N]``), a validity mask, and true batching into ``[B, 24000, …]`` (the
reference is locked to batch 1, README.md:61).
"""

from __future__ import annotations

import json
import os
from glob import glob

import numpy as np

from ..utils import profiling
from .augment import Augmentator

N_POINTS = 24000


class DentalScanDataset:
    def __init__(
        self,
        data_dir: str,
        split_txt_path: str | None = None,
        augmenter: Augmentator | None = None,
        seed: int = 0,
    ):
        self.data_dir = data_dir
        self.mesh_paths = sorted(glob(os.path.join(data_dir, "*_sampled_points.npy")))
        if split_txt_path:
            with open(split_txt_path) as f:
                keep = {line.strip() for line in f if line.strip()}
            self.mesh_paths = [
                p for p in self.mesh_paths
                if os.path.basename(p).split("_")[0] in keep
            ]
        self.augmenter = augmenter
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.mesh_paths)

    def __getitem__(self, idx: int) -> dict:
        path = self.mesh_paths[idx]
        arr = np.load(path)
        feat = arr[:, :6].astype(np.float32).copy()
        label = arr[:, 6].astype(np.int32) - 1  # −1 gingiva, 0..15 teeth

        n_valid = arr.shape[0]
        meta_path = path[:-4] + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                n_valid = json.load(f).get("n_valid", n_valid)
        mask = np.zeros(arr.shape[0], dtype=bool)
        mask[:n_valid] = True

        if self.augmenter is not None:
            self.augmenter.reload_vals(self.rng)
            feat = self.augmenter.run(feat)

        return {
            "feat": feat,                 # [N, 6]
            "gt_seg_label": label,        # [N]
            "mask": mask,                 # [N]
            "mesh_path": path,
            "augmenter": self.augmenter,
        }


def collate_batch(items: list[dict]) -> dict:
    """Stack per-item arrays into ``[B, …]`` numpy batches; non-array fields become
    lists (runner.py:7-19 contract, generalized past batch 1)."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class BatchLoader:
    """Shuffled epoch iterator yielding collated ``[B, …]`` batches.

    ``drop_last=True`` keeps the train batches' shapes fixed; validation uses
    ``drop_last=False`` with pad-to-batch + an item mask instead. The work
    behind each batch is a ``data.next`` span on a thread that traces
    (``utils/profiling.py``).
    """

    def __init__(self, dataset: DentalScanDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool | None = None, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        n_full = len(order) // bs
        for b in range(n_full):
            with profiling.span("data.next"):
                batch = collate_batch([self.dataset[int(i)]
                                       for i in order[b * bs:(b + 1) * bs]])
            yield batch
        rem = len(order) - n_full * bs
        if rem and not self.drop_last:
            with profiling.span("data.next"):
                idxs = order[n_full * bs:]
                items = [self.dataset[int(i)] for i in idxs]
                batch = collate_batch(items)
                batch["batch_valid"] = (np.arange(bs) < rem if rem < bs
                                        else np.ones(bs, bool))
                # pad to full batch by repeating the first item
                for k, v in list(batch.items()):
                    if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == rem and k != "batch_valid":
                        reps = [v] + [v[:1]] * (bs - rem)
                        batch[k] = np.concatenate(reps, axis=0)
            yield batch



def make_split_files(processed_dir: str, out_dir: str, seed: int = 42,
                     ratios=(0.8, 0.1, 0.1)) -> dict:
    """Random case-level train/val/test split.

    Case id = basename up to the first ``_``; both jaws of a case land in the same
    split. Writes ``train_fold.txt`` / ``val_fold.txt`` / ``test_fold.txt``.
    """
    paths = sorted(glob(os.path.join(processed_dir, "*_sampled_points.npy")))
    cases = sorted({os.path.basename(p).split("_")[0] for p in paths})
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(cases))
    n = len(cases)
    n_train = int(n * ratios[0])
    n_val = int(n * ratios[1])
    splits = {
        "train_fold.txt": [cases[i] for i in order[:n_train]],
        "val_fold.txt": [cases[i] for i in order[n_train:n_train + n_val]],
        "test_fold.txt": [cases[i] for i in order[n_train + n_val:]],
    }
    os.makedirs(out_dir, exist_ok=True)
    for fname, ids in splits.items():
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write("\n".join(ids) + ("\n" if ids else ""))
    return splits
