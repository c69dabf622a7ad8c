"""The reference's trained checkpoint (``model_XXXXXXXX.pth``) -> the
checkpoint format of both packages, numpy and torch only.

The port's copy of the flagship subset of ``tools/convert_torch_weights.py``
(its ``checkpoint`` kind, which writes through the JAX package's checkpoint
module and so needs JAX).  The flagship embedder (torchvision-layout
ResNeXt-50 and MobileNetV2), generator and discriminator, and the EMA
copies of the first two, are mapped by their state-dict keys: torch conv
OIHW -> HWIO, Linear (out, in) -> (in, out), BatchNorm weight/bias ->
scale/bias with the running statistics under ``batch_stats``, torch
``spectral_norm``'s (weight_orig, weight_u[, weight_v]) -> the raw kernel
and the ``spectral`` (u, v).  Where the file has no ``weight_v``, v is one
power-iteration half step from u, as the tool computes it.  The optimizers' state is not converted (the
reference's own fine-tune transition drops it too).  The result is the
tool's, array for array (``tests/test_torch_reference_ckpt.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from latentpose_tpu_torch import checkpoint as ckpt_lib


def conv_kernel(w):
    """OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def dense_kernel(w):
    """(out, in) -> (in, out)."""
    return np.transpose(w, (1, 0))


def _power_v(sd, prefix, w2d, u):
    v = sd.get(prefix + ".weight_v")
    if v is None:
        v = w2d.T @ u
        v = v / max(np.linalg.norm(v), 1e-12)
    return v


def sn_conv(sd, prefix):
    """torch spectral-norm conv -> (params, spectral) of ``SNConv``."""
    w = sd[prefix + ".weight_orig"]
    u = sd[prefix + ".weight_u"]
    v = _power_v(sd, prefix, w.reshape(w.shape[0], -1), u)
    params = {"kernel": conv_kernel(w)}
    if prefix + ".bias" in sd:
        params["bias"] = sd[prefix + ".bias"]
    return params, {"u": u, "v": v}


def sn_dense(sd, prefix):
    """torch spectral-norm Linear -> (params, spectral) of ``SNDense``."""
    w = sd[prefix + ".weight_orig"]
    u = sd[prefix + ".weight_u"]
    v = _power_v(sd, prefix, w, u)
    params = {"kernel": dense_kernel(w)}
    if prefix + ".bias" in sd:
        params["bias"] = sd[prefix + ".bias"]
    return params, {"u": u, "v": v}


def sn_embed(sd, prefix):
    """torch spectral-norm Embedding -> (params, spectral) of ``SNEmbed``."""
    w = sd[prefix + ".weight_orig"]
    u = sd[prefix + ".weight_u"]
    return {"embedding": w}, {"u": u, "v": _power_v(sd, prefix, w, u)}


def bn(sd, prefix):
    """BatchNorm2d -> (params, batch_stats)."""
    return ({"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]},
            {"mean": sd[prefix + ".running_mean"],
             "var": sd[prefix + ".running_var"]})


def _j(prefix, rest):
    """Join a (possibly empty) state-dict prefix with a sub-key."""
    return f"{prefix}.{rest}" if prefix else rest


def convert_resblock(sd, prefix, normalize, upsample):
    """The reference's ResBlock (``generators/common/blocks.py:47-111``) ->
    (params, spectral) of ``nn/blocks.py`` ``ResBlock``.

    torch Sequential indices (zero padding): with norm [norm0, ReLU, (Up),
    pad, conv0, norm1, ReLU, pad, conv1, (Pool)]; without norm the norms are
    absent.  'in' norms (InstanceNorm2d, affine) carry weight and bias; the
    generator's AdaIN norms carry none."""
    params, spectral = {}, {}

    def take_norm(name, idx):
        key = _j(prefix, f"block.{idx}.weight")
        if key in sd:
            params[name] = {"weight": sd[key],
                            "bias": sd[_j(prefix, f"block.{idx}.bias")]}

    idx = 0
    if normalize:
        take_norm("norm0", idx)
        idx += 1  # norm0
    idx += 1      # ReLU
    if upsample:
        idx += 1  # Upsample
    idx += 1      # empty pad Sequential
    conv0 = _j(prefix, f"block.{idx}")
    idx += 1
    if normalize:
        take_norm("norm1", idx)
        idx += 1  # norm1
    idx += 1      # ReLU
    idx += 1      # pad
    conv1 = _j(prefix, f"block.{idx}")

    params["conv0"], spectral["conv0"] = sn_conv(sd, conv0)
    params["conv1"], spectral["conv1"] = sn_conv(sd, conv1)
    skip_conv = _j(prefix, f"skip.{1 if upsample else 0}")
    if skip_conv + ".weight_orig" in sd:
        params["skip"], spectral["skip"] = sn_conv(sd, skip_conv)
    return params, spectral


def _infer_module_count(sd, prefix, fmt):
    """Highest consecutive index i for which any ``fmt.format(i)``-prefixed
    key exists (``decoder_blocks.{i}.``, ``blocks.{i}.``)."""
    n = 0
    while any(k.startswith(prefix + fmt.format(n)) for k in sd):
        n += 1
    return n


def convert_flagship_generator(sd, prefix="", num_blocks=None,
                               num_residual=2):
    """``vector_pose_unsupervised_segmentation_noBottleneck`` -> (params,
    spectral, extra); extra holds ``finetune_embedding`` for a fine-tuned
    checkpoint."""
    params, spectral = {}, {}
    pf = prefix
    if num_blocks is None:
        # decoder_blocks: num_blocks ResBlocks, then AdaIN and ReLU (no
        # parameters) and the head conv, so the scan stops at num_blocks
        num_blocks = _infer_module_count(sd, pf, "decoder_blocks.{}.")
    params["constant"] = np.transpose(sd[pf + "constant.constant"],
                                      (0, 2, 3, 1))
    for i in range(num_blocks):
        params[f"block{i}"], spectral[f"block{i}"] = convert_resblock(
            sd, pf + f"decoder_blocks.{i}", normalize=True,
            upsample=i >= num_residual)
    params["head_conv"], spectral["head_conv"] = sn_conv(
        sd, pf + f"decoder_blocks.{num_blocks + 2}")
    params["projector_0"], spectral["projector_0"] = sn_dense(
        sd, pf + "affine_params_projector.0")
    params["projector_1"], spectral["projector_1"] = sn_dense(
        sd, pf + "affine_params_projector.2")
    extra = {}
    if pf + "identity_embedding" in sd:  # fine-tuned checkpoint
        extra["finetune_embedding"] = sd[pf + "identity_embedding"]
    return params, spectral, extra


def convert_flagship_discriminator(sd, prefix="", num_blocks=None):
    """``no_landmarks`` -> (params, spectral)."""
    params, spectral = {}, {}
    pf = prefix
    if num_blocks is None:
        num_blocks = _infer_module_count(sd, pf, "blocks.{}.")
    for ours, theirs in (("stem_conv0", "down_block.0"),
                         ("stem_conv1", "down_block.2"),
                         ("stem_skip", "skip.0")):
        params[ours], spectral[ours] = sn_conv(sd, pf + theirs)
    for i in range(num_blocks):
        # norm 'none': [ReLU, pad, conv0, ReLU, pad, conv1, (pool)]
        params[f"block{i}"], spectral[f"block{i}"] = convert_resblock(
            sd, pf + f"blocks.{i}", normalize=False, upsample=False)
    params["linear"], spectral["linear"] = sn_dense(sd, pf + "linear")
    params["embed"], spectral["embed"] = sn_embed(sd, pf + "embed")
    return params, spectral


def convert_resnext50(sd, prefix=""):
    """torchvision ``resnext50_32x4d`` -> (params, batch_stats)."""
    params, stats = {}, {}
    params["conv1"] = {"kernel": conv_kernel(sd[prefix + "conv1.weight"])}
    params["bn1"], stats["bn1"] = bn(sd, prefix + "bn1")
    for stage, blocks in enumerate((3, 4, 6, 3), start=1):
        for i in range(blocks):
            t = f"{prefix}layer{stage}.{i}."
            block_p, block_s = {}, {}
            for c in ("conv1", "conv2", "conv3"):
                block_p[c] = {"kernel": conv_kernel(sd[t + c + ".weight"])}
            for b in ("bn1", "bn2", "bn3"):
                block_p[b], block_s[b] = bn(sd, t + b)
            if t + "downsample.0.weight" in sd:
                block_p["downsample_conv"] = {"kernel": conv_kernel(
                    sd[t + "downsample.0.weight"])}
                block_p["downsample_bn"], block_s["downsample_bn"] = bn(
                    sd, t + "downsample.1")
            params[f"layer{stage}_{i}"] = block_p
            stats[f"layer{stage}_{i}"] = block_s
    params["fc"] = {"kernel": dense_kernel(sd[prefix + "fc.weight"]),
                    "bias": sd[prefix + "fc.bias"]}
    return params, stats


def convert_mobilenet_v2(sd, prefix=""):
    """torchvision ``mobilenet_v2`` -> (params, batch_stats)."""
    params, stats = {}, {}

    def put(ours_conv, ours_bn, theirs_conv, theirs_bn, block_p, block_s):
        block_p[ours_conv] = {"kernel": conv_kernel(
            sd[prefix + theirs_conv + ".weight"])}
        block_p[ours_bn], block_s[ours_bn] = bn(sd, prefix + theirs_bn)

    params["stem_conv"] = {"kernel": conv_kernel(
        sd[prefix + "features.0.0.weight"])}
    params["stem_bn"], stats["stem_bn"] = bn(sd, prefix + "features.0.1")
    settings = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
    feature_idx = block_idx = 0
    for t, _, n, _ in settings:
        for _ in range(n):
            feature_idx += 1
            th = f"features.{feature_idx}.conv."
            block_p, block_s = {}, {}
            if t == 1:
                # [0] the depthwise ConvBNReLU, [1] project conv, [2] its BN
                put("conv0", "bn0", th + "0.0", th + "0.1", block_p, block_s)
                put("conv1", "bn1", th + "1", th + "2", block_p, block_s)
            else:
                put("conv0", "bn0", th + "0.0", th + "0.1", block_p, block_s)
                put("conv1", "bn1", th + "1.0", th + "1.1", block_p, block_s)
                put("conv2", "bn2", th + "2", th + "3", block_p, block_s)
            params[f"block{block_idx}"] = block_p
            stats[f"block{block_idx}"] = block_s
            block_idx += 1
    params["head_conv"] = {"kernel": conv_kernel(
        sd[prefix + "features.18.0.weight"])}
    params["head_bn"], stats["head_bn"] = bn(sd, prefix + "features.18.1")
    params["classifier"] = {
        "kernel": dense_kernel(sd[prefix + "classifier.1.weight"]),
        "bias": sd[prefix + "classifier.1.bias"]}
    return params, stats


def convert_flagship_embedder(sd, prefix=""):
    """``unsupervised_pose_separate_embResNeXt_segmentation`` -> (params,
    batch_stats)."""
    idt_p, idt_s = convert_resnext50(sd, prefix + "identity_encoder.")
    pose_p, pose_s = convert_mobilenet_v2(sd, prefix + "pose_encoder.")
    return ({"identity_encoder": idt_p, "pose_encoder": pose_p},
            {"identity_encoder": idt_s, "pose_encoder": pose_s})


def _numpy(state_dict):
    return {k: v.detach().numpy() for k, v in state_dict.items()}


def convert_reference_checkpoint(in_path, out_dir):
    """Read the reference's ``model_XXXXXXXX.pth`` and write the checkpoint
    directory ``out_dir`` (``arrays.npz`` and ``meta.json``, the tool's
    ``checkpoint`` kind); returns ``out_dir``.  A fine-tuned file (with the
    generator's ``identity_embedding``) gives a fine-tuned checkpoint."""
    import torch
    ckpt = torch.load(in_path, map_location="cpu", weights_only=False)
    args = ckpt.get("args")
    args_dict = vars(args) if args is not None else {}

    emb_p, emb_stats = convert_flagship_embedder(_numpy(ckpt["embedder"]))
    gen_p, gen_spec, gen_extra = convert_flagship_generator(
        _numpy(ckpt["generator"]))
    dis_p, dis_spec = convert_flagship_discriminator(
        _numpy(ckpt["discriminator"]))
    params = {"embedder": emb_p, "generator": gen_p, "discriminator": dis_p}
    params.update(gen_extra)
    state_dict = {
        "step": np.int32(args_dict.get("iteration", 0)),
        "params": params,
        "batch_stats": {"embedder": emb_stats},
        "spectral": {"embedder": {}, "generator": gen_spec,
                     "discriminator": dis_spec},
        "ema_params": {},
    }
    averages = ckpt.get("running_averages", {})
    if "embedder" in averages:
        state_dict["ema_params"]["embedder"] = convert_flagship_embedder(
            _numpy(averages["embedder"]))[0]
    if "generator" in averages:
        ema_p, _, ema_extra = convert_flagship_generator(
            _numpy(averages["generator"]))
        state_dict["ema_params"]["generator"] = ema_p
        if "finetune_embedding" in ema_extra:
            state_dict["ema_params"]["finetune_embedding"] = \
                ema_extra["finetune_embedding"]

    meta = {"format_version": 1,
            "iteration": int(args_dict.get("iteration", 0)),
            "finetune": "finetune_embedding" in params,
            "args": {k: (v if isinstance(
                v, (int, float, str, bool, list, type(None))) else str(v))
                for k, v in args_dict.items()},
            "converted_from": str(in_path)}
    ckpt_lib.write_arrays(out_dir, ckpt_lib.flatten(state_dict), meta)
    return Path(out_dir)
