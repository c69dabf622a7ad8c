"""How far f32 gradients of ResNeXt-50's train form sit from f64 ones, in
the JAX package and in the PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python tools/train_bn_conditioning.py \
        [--layers 1,1,1,1] [--size 64] [--frames 4] [--jitter 0.05]

A network of train-mode BatchNorms amplifies rounding at every block, by an
amount that depends on its depth, inputs and weights.  The script takes the
JAX module's init moved by ``--jitter`` (uniform) as the weights, runs the
JAX module in f64 as the reference, and prints, for the JAX module in f32
and for the port in f32, each parameter gradient's largest error as a
fraction of the leaf's largest |gradient| (worst leaves and the median) and
the output's.  ``tests/test_torch_models.py`` and
``tests/test_torch_metatrain.py`` choose their sizes from what it shows.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from latentpose_tpu.checkpoint import _flatten  # noqa: E402
from latentpose_tpu.nn import backbones as jbackbones  # noqa: E402
from latentpose_tpu_torch import convert  # noqa: E402
from latentpose_tpu_torch.nn import backbones as tbackbones  # noqa: E402


def jax_grads(net, variables, x, cot, dtype):
    """(output, {leaf: gradient}) of sum(out * cot), train form, in dtype."""
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)

    def loss(params):
        out, _ = net.apply({"params": params,
                            "batch_stats": cast["batch_stats"]},
                           jnp.asarray(x, dtype), train=True,
                           mutable=["batch_stats"])
        return (out * jnp.asarray(cot, dtype)).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        cast["params"])
    return np.asarray(out), _flatten({"params": grads})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--layers", default="1,1,1,1")
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--frames", type=int, default=4)
    parser.add_argument("--jitter", type=float, default=0.05)
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    layers = tuple(int(n) for n in args.layers.split(","))
    rng = np.random.RandomState(50)
    x = rng.rand(args.frames, args.size, args.size, 3).astype(np.float32)
    cot = rng.standard_normal((args.frames, 16)).astype(np.float32)
    net = jbackbones.ResNeXt50(num_classes=16, layers=layers)
    variables = jax.jit(net.init)(jax.random.PRNGKey(51), jnp.asarray(x))
    jitter = np.random.RandomState(52)
    variables = {"params": jax.tree_util.tree_map(
        lambda v: np.asarray(v) + jitter.uniform(
            -args.jitter, args.jitter, v.shape).astype(np.float32),
        variables["params"]), "batch_stats": variables["batch_stats"]}
    with jax.enable_x64(True):
        out64, g64 = jax_grads(net, variables, x, cot, jnp.float64)
    out32, g32 = jax_grads(net, variables, x, cot, jnp.float32)

    port = tbackbones.ResNeXt50(num_classes=16, layers=layers)
    convert.load_into(port, _flatten(variables), "")
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    (out * torch.from_numpy(cot)).sum().backward()
    params = dict(port.named_parameters())
    rows = []
    for tkey, coll, leaf, (_, to_jax) in convert._rules(port):
        if coll != "params":
            continue
        got = params[tkey].grad.numpy()
        got = got.transpose(to_jax) if to_jax is not None else got
        want = g64[f"params::{leaf}"]
        scale = np.abs(want).max()
        rows.append((np.abs(got - want).max() / scale,
                     np.abs(g32[f"params::{leaf}"] - want).max() / scale,
                     leaf))
    scale = np.abs(out64).max()
    print(f"ResNeXt-50 train form, layers {layers}, {args.frames} frames of "
          f"{args.size}², weights init + U(±{args.jitter}); error / max "
          f"|f64|:")
    print(f"output: port f32 {np.abs(out.detach().numpy() - out64).max() / scale:.3g}"
          f", JAX f32 {np.abs(out32 - out64).max() / scale:.3g}")
    for name, col in (("port f32", 0), ("JAX f32", 1)):
        worst = sorted(rows, key=lambda r: -r[col])[:3]
        print(f"gradients, {name}: median {np.median([r[col] for r in rows]):.3g}"
              f", worst " + ", ".join(f"{r[2]} {r[col]:.3g}" for r in worst))


if __name__ == "__main__":
    main()
