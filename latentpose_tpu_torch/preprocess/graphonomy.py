"""Graphonomy universal human parser (port of
``latentpose_tpu/preprocess/graphonomy.py``): DeepLabV3+ (an aligned
Xception-65 backbone at output stride 16, ASPP with image pooling, a decoder
at stride 4) with graph reasoning over the 20 CIHP classes: per-class node
features pooled by the softmaxed logits, two GCN layers over a learned
label adjacency, re-projected and fused into the map.

RGB in [0, 1] in, per-pixel class probabilities out; the person mask is
1 - P(background) (:func:`person_mask`).  Attribute names mirror the flax
tree, so ``graphonomy.npz`` loads into both packages (``utils/weights.py``).
Eval-form BatchNorm (eps 1e-5).  The JAX package's two
``jax.image.resize(..., "bilinear")`` calls are upsamples with half-pixel
centres, which ``F.interpolate(..., align_corners=False)`` computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

CIHP_NUM_CLASSES = 20  # class 0 = background
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _bn(features):
    return nn.BatchNorm2d(features, eps=1e-5)


class SeparableConv(nn.Module):
    """Depthwise 3x3 (dilated, padding = dilation) -> BN -> pointwise 1x1
    -> BN."""

    def __init__(self, in_features, features, stride=1, dilation=1):
        super().__init__()
        self.depthwise = nn.Conv2d(in_features, in_features, 3, stride=stride,
                                   padding=dilation, dilation=dilation,
                                   groups=in_features, bias=False)
        self.bn_dw = _bn(in_features)
        self.pointwise = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn_pw = _bn(features)

    def forward(self, x):
        return self.bn_pw(self.pointwise(self.bn_dw(self.depthwise(x))))


class XceptionBlock(nn.Module):
    """ReLU -> SeparableConv per width (the last one strided), plus a
    1x1-conv + BN skip ('conv'), the input ('sum') or nothing ('none')."""

    def __init__(self, in_features, features, stride=1, dilation=1,
                 skip_type="conv"):
        super().__init__()
        self.skip_type = skip_type
        self.n = len(features)
        cin = in_features
        for i, f in enumerate(features):
            s = stride if i == len(features) - 1 else 1
            setattr(self, f"sep{i}", SeparableConv(cin, f, s, dilation))
            cin = f
        if skip_type == "conv":
            self.skip_conv = nn.Conv2d(in_features, features[-1], 1,
                                       stride=stride, bias=False)
            self.skip_bn = _bn(features[-1])

    def forward(self, x):
        h = x
        for i in range(self.n):
            h = getattr(self, f"sep{i}")(F.relu(h))
        if self.skip_type == "conv":
            return h + self.skip_bn(self.skip_conv(x))
        if self.skip_type == "sum":
            return h + x
        return h


class Xception65(nn.Module):
    """The modified aligned Xception (output stride 16); the widths and
    depth default to the real Xception-65 and are parameters so that tests
    run it narrow."""

    def __init__(self, stem_widths=(32, 64), entry_widths=(128, 256, 728),
                 middle_blocks=16,
                 exit_widths=(728, 1024, 1536, 1536, 2048)):
        super().__init__()
        s1, s2 = stem_widths
        self.conv1 = nn.Conv2d(3, s1, 3, stride=2, padding=1, bias=False)
        self.bn1 = _bn(s1)
        self.conv2 = nn.Conv2d(s1, s2, 3, padding=1, bias=False)
        self.bn2 = _bn(s2)
        e1, e2, e3 = entry_widths
        self.block1 = XceptionBlock(s2, (e1,) * 3, stride=2)
        self.block2 = XceptionBlock(e1, (e2,) * 3, stride=2)
        self.block3 = XceptionBlock(e2, (e3,) * 3, stride=2)
        self.middle_blocks = middle_blocks
        for i in range(middle_blocks):
            setattr(self, f"mid{i}", XceptionBlock(e3, (e3,) * 3,
                                                   skip_type="sum"))
        x1, x2, x3, x4, x5 = exit_widths
        self.exit1 = XceptionBlock(e3, (x1, x2, x2))
        self.exit_sep1 = SeparableConv(x2, x3, dilation=2)
        self.exit_sep2 = SeparableConv(x3, x4, dilation=2)
        self.exit_sep3 = SeparableConv(x4, x5, dilation=2)
        self.out_features = x5
        self.low_features = e1

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.block1(h)
        low_level = h                   # stride 4, for the decoder
        h = self.block3(self.block2(h))
        for i in range(self.middle_blocks):
            h = getattr(self, f"mid{i}")(h)
        h = self.exit1(h)
        h = F.relu(self.exit_sep1(h))
        h = F.relu(self.exit_sep2(h))
        h = F.relu(self.exit_sep3(h))
        return h, low_level


class ASPP(nn.Module):
    def __init__(self, in_features, features=256, rates=(6, 12, 18)):
        super().__init__()
        self.rates = rates
        self.b0 = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn0 = _bn(features)
        for i, rate in enumerate(rates):
            setattr(self, f"b{i + 1}", nn.Conv2d(
                in_features, features, 3, padding=rate, dilation=rate,
                bias=False))
            setattr(self, f"bn{i + 1}", _bn(features))
        self.b_pool = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn_pool = _bn(features)
        self.proj = nn.Conv2d(features * (len(rates) + 2), features, 1,
                              bias=False)
        self.bn_proj = _bn(features)

    def forward(self, x):
        branches = [F.relu(self.bn0(self.b0(x)))]
        for i in range(len(self.rates)):
            branches.append(F.relu(getattr(self, f"bn{i + 1}")(
                getattr(self, f"b{i + 1}")(x))))
        pooled = F.relu(self.bn_pool(self.b_pool(
            x.mean(dim=(2, 3), keepdim=True))))
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        return F.relu(self.bn_proj(self.proj(torch.cat(branches, dim=1))))


class GraphReasoning(nn.Module):
    """Node features pooled by the softmaxed logits, two GCN layers over the
    softmaxed learned adjacency, re-projected into the map, fused."""

    def __init__(self, features, num_nodes=CIHP_NUM_CLASSES,
                 node_features=128):
        super().__init__()
        self.node_proj = nn.Linear(features, node_features)
        self.adjacency = nn.Parameter(torch.eye(num_nodes))
        self.gcn1 = nn.Linear(node_features, node_features)
        self.gcn2 = nn.Linear(node_features, node_features)
        self.fuse = nn.Conv2d(features + node_features, features, 1)

    def forward(self, feats, logits):
        b, c, h, w = feats.shape
        assign = torch.softmax(logits, dim=1).flatten(2)        # (B, N, P)
        feats_flat = feats.flatten(2)                            # (B, C, P)
        weights_sum = assign.sum(dim=2, keepdim=True) + 1e-6     # (B, N, 1)
        nodes = torch.einsum("bnp,bcp->bnc", assign, feats_flat) / weights_sum
        nodes = self.node_proj(nodes)
        adj = torch.softmax(self.adjacency, dim=-1)
        nodes = F.relu(self.gcn1(torch.einsum("nm,bmc->bnc", adj, nodes)))
        nodes = F.relu(self.gcn2(torch.einsum("nm,bmc->bnc", adj, nodes)))
        back = torch.einsum("bnp,bnc->bcp", assign, nodes).reshape(
            b, -1, h, w)
        return F.relu(self.fuse(torch.cat([feats, back], dim=1)))


class Graphonomy(nn.Module):
    def __init__(self, num_classes=CIHP_NUM_CLASSES, backbone_cfg=None,
                 aspp_features=256):
        super().__init__()
        self.backbone = Xception65(**(backbone_cfg or {}))
        self.aspp = ASPP(self.backbone.out_features, aspp_features)
        self.low_proj = nn.Conv2d(self.backbone.low_features, 48, 1,
                                  bias=False)
        self.low_bn = _bn(48)
        self.dec1 = nn.Conv2d(aspp_features + 48, 256, 3, padding=1,
                              bias=False)
        self.dec_bn1 = _bn(256)
        self.dec2 = nn.Conv2d(256, 256, 3, padding=1, bias=False)
        self.dec_bn2 = _bn(256)
        self.classifier = nn.Conv2d(256, num_classes, 1)
        self.graph = GraphReasoning(256, num_classes)
        self.classifier_refine = nn.Conv2d(256, num_classes, 1)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, images):
        """images: (B, 3, H, W) float32 in [0, 1].  Returns (B, classes, H,
        W) probabilities."""
        feats, low_level = self.backbone((images - self.mean) / self.std)
        h = self.aspp(feats)
        h = F.interpolate(h, size=low_level.shape[2:], mode="bilinear",
                          align_corners=False)
        low = F.relu(self.low_bn(self.low_proj(low_level)))
        h = torch.cat([h, low], dim=1)
        h = F.relu(self.dec_bn1(self.dec1(h)))
        h = F.relu(self.dec_bn2(self.dec2(h)))
        logits = self.classifier(h)
        h = self.graph(h, logits)
        logits = logits + self.classifier_refine(h)
        logits = F.interpolate(logits, size=images.shape[2:], mode="bilinear",
                               align_corners=False)
        return torch.softmax(logits, dim=1)


def person_mask(probs):
    """(B, classes, H, W) -> (B, H, W) person probability, 1 - P(background)
    (channel 0 in CIHP)."""
    return 1.0 - probs[:, 0]
