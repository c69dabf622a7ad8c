"""Convert the reference's trained checkpoint into the checkpoint format
that the port (and the JAX package) read:

    python -m latentpose_tpu_torch.cli.convert_reference_checkpoint \
        model_XXXXXXXX.pth OUT_DIR

OUT_DIR becomes a checkpoint directory (``arrays.npz``, ``meta.json``): a
meta-trained one, which ``cli.train --finetune --checkpoint_path OUT_DIR``
fine-tunes, or, from a fine-tuned file, one that ``cli.drive`` and
``cli.export`` serve.  Needs numpy and torch only
(``reference_checkpoint.py``); the conversion is host work (transposes, and
one matrix-vector product for each spectral-norm layer stored without its
v), so it takes no ``--device``.  The other weight kinds of
``tools/convert_torch_weights.py`` (vgg19, vggface, fan, s3fd, graphonomy,
lpips) already need no JAX and stay there.
"""

from __future__ import annotations

import argparse
import logging

from latentpose_tpu_torch.reference_checkpoint import \
    convert_reference_checkpoint

logger = logging.getLogger("latentpose_tpu_torch.convert_reference_checkpoint")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("input", help="the reference's model_XXXXXXXX.pth")
    parser.add_argument("output_dir", help="the checkpoint directory to write")
    args = parser.parse_args(argv)
    out = convert_reference_checkpoint(args.input, args.output_dir)
    logger.info("Wrote %s", out)
    return out


if __name__ == "__main__":
    main()
