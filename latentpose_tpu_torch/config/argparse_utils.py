"""Argument-parser plumbing (port of ``latentpose_tpu/config/
argparse_utils.py``): ``MyArgumentParser.add``, an alias of
``add_argument`` that understands ``action='store_bool'`` (``--x`` sets
True, ``--no-x`` and ``--no_x`` set False, into one dest), and
:func:`flag_given`."""

from __future__ import annotations

import argparse


class _StoreBool(argparse.Action):
    def __init__(self, *args, value, **kwargs):
        super().__init__(*args, **kwargs)
        self.value = value

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, self.value)


class MyArgumentParser(argparse.ArgumentParser):
    """``argparse.ArgumentParser`` with ``.add`` and ``store_bool``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.add = self.add_argument

    def add_argument(self, *args, **kwargs):
        if kwargs.get("action") != "store_bool":
            return super().add_argument(*args, **kwargs)
        kwargs.pop("action")
        default = kwargs.pop("default", None)
        required = kwargs.pop("required", False)
        help_msg = kwargs.pop("help", None)
        flags = [a for a in args if a.startswith("--")]
        if not flags:
            raise ValueError("store_bool needs a --flag style option")
        negative = ["--no-" + f[2:] for f in flags] + [
            "--no_" + f[2:] for f in flags if "-" not in f[2:]]
        dest = kwargs.pop("dest", None) or flags[0][2:].replace("-", "_")
        group = super().add_mutually_exclusive_group(required=required)
        group.add_argument(*flags, dest=dest, nargs=0, action=_StoreBool,
                           value=True, help=help_msg, **kwargs)
        group.add_argument(*dict.fromkeys(negative), dest=dest, nargs=0,
                           action=_StoreBool, value=False,
                           help=argparse.SUPPRESS, **kwargs)
        self.set_defaults(**{dest: default})
        return group


def flag_given(argv, flag):
    """Whether ``flag`` is in ``argv``, bare or as ``--flag=value``."""
    return any(a == flag or a.startswith(flag + "=") for a in argv)
