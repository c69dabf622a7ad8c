"""Argument resolution and the configs' reader (port of
``latentpose_tpu/config/``)."""

from latentpose_tpu_torch.config.argparse_utils import (MyArgumentParser,
                                                        flag_given)
from latentpose_tpu_torch.config.core_args import build_core_parser
from latentpose_tpu_torch.config.resolution import (add_plugin_args,
                                                    get_args_and_modules,
                                                    load_yaml_config,
                                                    plugin_defaults)

__all__ = ["MyArgumentParser", "add_plugin_args", "build_core_parser",
           "flag_given", "get_args_and_modules", "load_yaml_config",
           "plugin_defaults"]
