"""Train/val/test split CLI (counterpart of
toothgroupnetwork_tpu/cli/split.py, the same arguments and output).

    python -m toothgroupnetwork_tpu_torch.cli.split \\
        --processed_data_path processed --out_dir splits
"""

import argparse

from ..data.dataset import make_split_files


def main(argv=None):
    parser = argparse.ArgumentParser(description="Make case-level split txt files")
    parser.add_argument("--processed_data_path", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)
    splits = make_split_files(args.processed_data_path, args.out_dir, args.seed)
    for name, ids in splits.items():
        print(f"{name}: {len(ids)} cases")
    return splits


if __name__ == "__main__":
    main()
