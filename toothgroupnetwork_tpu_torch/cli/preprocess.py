"""Offline preprocessing CLI (counterpart of
toothgroupnetwork_tpu/cli/preprocess.py: the same arguments, plus
``--device``, the card by default, where K1 samples each scan).

    python -m toothgroupnetwork_tpu_torch.cli.preprocess \\
        --source_obj_data_path objs --source_json_data_path jsons \\
        --save_data_path processed
"""

import argparse

from ..data.preprocess import preprocess_dir
from ..utils.device import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess dental scans to 24k-point npy")
    parser.add_argument("--source_obj_data_path", required=True,
                        help="dir of per-patient subdirs containing .obj scans")
    parser.add_argument("--source_json_data_path", required=True,
                        help="dir of per-patient subdirs containing label .json files")
    parser.add_argument("--save_data_path", default="data_preprocessed_path")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    n = preprocess_dir(args.source_obj_data_path, args.source_json_data_path,
                       args.save_data_path, device=device)
    print(f"preprocessed {n} scans -> {args.save_data_path}")
    return n


if __name__ == "__main__":
    main()
