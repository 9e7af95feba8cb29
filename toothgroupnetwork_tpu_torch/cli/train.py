"""Training CLI (counterpart of toothgroupnetwork_tpu/cli/train.py: the same
arguments, plus ``--device``, the card by default).

    python -m toothgroupnetwork_tpu_torch.cli.train --model_name tgnet_fps \\
        --input_data_dir_path processed --checkpoint_path ckpts/fps \\
        --max_epochs 40

``--config_path`` reads a ``TrainConfig`` JSON, the one the JAX package's
``TrainConfig.save_json`` writes.

``--data_parallel D`` (D > 1) spawns D rank processes in one
``torch.distributed`` group (``parallel.RankPool``: start method ``spawn``,
a ``file://`` store in a temporary directory), each training on its rows
of every global batch (``--batch_size`` must divide by D). With ``--device
cuda`` rank r takes ``cuda:r`` where the machine has D cards, over NCCL,
and ``cuda:0`` otherwise, the ranks sharing the card over gloo; with
``--device cpu`` the ranks run on the CPU over gloo. Rank 0 logs and
writes the checkpoints; ``main`` then returns rank 0's summary (``epoch``,
``step``, ``best_val``) instead of the ``Trainer``.
"""

import argparse
import os
import sys

from ..data.augment import build_augmenter
from ..data.dataset import BatchLoader, DentalScanDataset
from ..models import available_models, get_task
from ..parallel.distributed import RankPool
from ..train.config import TrainConfig
from ..train.trainer import CUBLAS_WORKSPACE, Trainer
from ..utils.device import resolve_device


def _parser():
    parser = argparse.ArgumentParser(description="Train a tooth segmentation model")
    parser.add_argument("--model_name", required=True, choices=available_models())
    parser.add_argument("--config_path", default=None,
                        help="optional TrainConfig json overriding the preset")
    parser.add_argument("--experiment_name", default="exp")
    parser.add_argument("--input_data_dir_path", required=True)
    parser.add_argument("--train_data_split_txt_path", default=None)
    parser.add_argument("--val_data_split_txt_path", default=None)
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--data_parallel", type=int, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None):
    args = _parser().parse_args(argv)
    # before any CUDA work: the cuBLAS workspace deterministic steps need
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    device = resolve_device(args.device)
    ranks = _config(args).data_parallel
    if ranks > 1:
        argv = sys.argv[1:] if argv is None else list(argv)
        with RankPool(ranks, device.type) as pool:
            return pool.run(_train_rank, argv)[0]
    return _train(args, device)


def _train_rank(mesh, argv):
    """One rank of ``--data_parallel``: train on the rank's device (rank 0
    prints); returns the run's summary."""
    trainer = _train(_parser().parse_args(argv), mesh.device,
                     say=print if mesh.rank == 0 else (lambda *_: None))
    return {"epoch": trainer.epoch, "step": trainer.step,
            "best_val": trainer.best_val}


def _config(args) -> TrainConfig:
    task = get_task(args.model_name)
    if args.config_path:
        config = TrainConfig.load_json(args.config_path)
    else:
        config = task.default_config()
    config.experiment_name = args.experiment_name
    config.generator.input_data_dir_path = args.input_data_dir_path
    config.generator.train_data_split_txt_path = args.train_data_split_txt_path
    config.generator.val_data_split_txt_path = args.val_data_split_txt_path
    config.checkpoint_path = args.checkpoint_path or f"ckpts/{args.experiment_name}"
    if args.max_epochs is not None:
        config.max_epochs = args.max_epochs
    if args.batch_size is not None:
        config.generator.train_batch_size = args.batch_size
        config.generator.val_batch_size = args.batch_size
    if args.data_parallel is not None:
        config.data_parallel = args.data_parallel
    return config


def _train(args, device, say=print):
    config = _config(args)
    task = get_task(args.model_name)

    train_ds = DentalScanDataset(
        config.generator.input_data_dir_path,
        config.generator.train_data_split_txt_path,
        build_augmenter(config.generator.aug_specs),
        seed=config.seed,
    )
    val_ds = DentalScanDataset(
        config.generator.input_data_dir_path,
        config.generator.val_data_split_txt_path,
    )
    train_loader = BatchLoader(train_ds, config.generator.train_batch_size,
                               shuffle=True, seed=config.seed)
    val_loader = BatchLoader(val_ds, config.generator.val_batch_size, shuffle=False)
    say(f"train scans: {len(train_ds)}, val scans: {len(val_ds)}")

    trainer = Trainer(config, task, train_loader, val_loader, log_fn=say,
                      device=device)
    if args.resume:
        epoch = trainer.resume()
        say(f"resumed at epoch {epoch}")
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
