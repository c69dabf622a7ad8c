"""The CLI arguments shared by every entry point (port of
``latentpose_tpu/config/core_args.py``): the same flags, types and
defaults, so that a command line resolves to the same args in both
packages."""

from __future__ import annotations

from pathlib import Path

from latentpose_tpu_torch.config.argparse_utils import MyArgumentParser


def build_core_parser() -> MyArgumentParser:
    parser = MyArgumentParser(conflict_handler="resolve")
    parser.add("--config_name", "--config", type=str, default="")

    parser.add("--generator", type=str, default="")
    parser.add("--embedder", type=str, default="")
    parser.add("--discriminator", type=str, default="")
    parser.add("--criterions", type=str, default="")
    parser.add("--metrics", type=str, default="")
    parser.add("--dataloader", type=str, default="")
    parser.add("--runner", type=str, default="")

    parser.add("--args-to-ignore", type=str,
               default="checkpoint,splits_dir,experiments_dir,extension,"
                       "experiment_name,rank,local_rank,world_size")
    parser.add("--experiments_dir", type=Path, default="data/experiments")
    parser.add("--experiment_name", type=str, default="")
    parser.add("--train_split_path", type=Path, default="data/splits/train.csv")
    parser.add("--val_split_path", type=Path, default="data/splits/val.csv")

    parser.add("--vgg_weights_dir", type=str, default="data/weights")
    parser.add("--allow_random_vgg", action="store_bool", default=False)

    parser.add("--num_epochs", type=int, default=10 ** 9)
    parser.add("--set_eval_mode_in_train", action="store_bool", default=False)
    parser.add("--set_eval_mode_in_test", action="store_bool", default=True)
    parser.add("--save_frequency", type=int, default=1)
    parser.add("--logging", action="store_bool", default=True)
    parser.add("--skip_eval", action="store_bool", default=True)
    parser.add("--weights_running_average", action="store_bool", default=True)
    parser.add("--finetune", action="store_bool", default=False)
    parser.add("--inference", action="store_bool", default=False)

    parser.add("--in_channels", type=int, default=3)
    parser.add("--out_channels", type=int, default=3)
    parser.add("--num_channels", type=int, default=64)
    parser.add("--max_num_channels", type=int, default=512)
    parser.add("--embed_channels", type=int, default=512)
    parser.add("--pose_embedding_size", type=int, default=136)
    parser.add("--image_size", type=int, default=256)

    parser.add("--optimizer", default="Adam", type=str,
               choices=["Adam", "RAdam"])
    parser.add("--lr_gen", default=5e-5, type=float)
    parser.add("--beta1", default=0.0, type=float)

    parser.add("--batch_size", type=int, default=8,
               help="Global batch size (split over the ranks)")
    parser.add("--num_workers", type=int, default=4)
    parser.add("--prefetch_size", type=int, default=16)
    parser.add("--data_root", type=str, default="")
    parser.add("--img_dir", type=str, default="images-cropped")
    parser.add("--kp_dir", type=str, default="keypoints-cropped")
    parser.add("--segm_dir", type=str, default="segmentation-cropped")
    parser.add("--bboxes_dir", type=str, default="/non/existent/file")
    parser.add("--num_labels", type=int, default=0,
               help="Rows of the discriminator's identity embedding; 0 = "
                    "the dataset's identities")

    parser.add("--num_devices", type=int, default=0,
               help="Ranks (one a device); 0 = every visible device")
    parser.add("--param_sharding", type=str, default="replicated",
               choices=["replicated", "fsdp"])
    parser.add("--compute_dtype", type=str, default="float32",
               choices=["float32", "bfloat16"])

    parser.add("--profile_dir", type=str, default="")
    parser.add("--profile_steps", type=int, default=5)

    parser.add("--random_seed", type=int, default=123)
    parser.add("--checkpoint_path", type=str, default="")
    parser.add("--saver", type=str, default="")
    return parser
