"""S³FD face detector (port of ``latentpose_tpu/preprocess/s3fd.py``).

A VGG16 trunk (conv1_1..conv5_3), fc6 / fc7 as convolutions, two extra
stages (conv6, conv7), and six detection heads: conv3_3 (L2Norm, max-out
background), conv4_3 and conv5_3 (L2Norm), fc7, conv6_2, conv7_2, with
anchor strides 4..128 and scales 16..512.  Attribute names mirror the flax
tree, so ``s3fd.npz`` (``tools/convert_torch_weights.py``) loads into both
packages (``utils/weights.py``).

Frames of one size go through the net as a batch; the boxes are thresholded
and decoded on the device (:func:`decode_detections`), in the JAX package's
order (heads in order, positions row-major), and suppressed on the host with
the JAX package's greedy :func:`nms`, so that ties break the same way.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VGG_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
STRIDES = (4, 8, 16, 32, 64, 128)
SCALES = (16, 32, 64, 128, 256, 512)
# caffe-style input: RGB * 255 minus these
MEAN_RGB = (123.0, 117.0, 104.0)


class L2Norm(nn.Module):
    def __init__(self, features, init_scale=10.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((features,), init_scale))

    def forward(self, x):
        norm = torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-10)
        return x / norm * self.scale.view(1, -1, 1, 1)


class S3FD(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for stage, (features, reps) in enumerate(VGG_CFG, start=1):
            for i in range(reps):
                setattr(self, f"conv{stage}_{i + 1}",
                        nn.Conv2d(cin, features, 3, padding=1))
                cin = features
        # fc6: k=3, pad=3, dilation=3 (size-preserving)
        self.fc6 = nn.Conv2d(512, 1024, 3, padding=3, dilation=3)
        self.fc7 = nn.Conv2d(1024, 1024, 1)
        self.conv6_1 = nn.Conv2d(1024, 256, 1)
        self.conv6_2 = nn.Conv2d(256, 512, 3, stride=2, padding=1)
        self.conv7_1 = nn.Conv2d(512, 128, 1)
        self.conv7_2 = nn.Conv2d(128, 256, 3, stride=2, padding=1)
        self.l2norm3 = L2Norm(256, 10.0)
        self.l2norm4 = L2Norm(512, 8.0)
        self.l2norm5 = L2Norm(512, 5.0)
        for i, ch in enumerate((256, 512, 512, 1024, 512, 256)):
            # conv3_3's head: 3 background channels, max-out below
            setattr(self, f"cls{i}", nn.Conv2d(ch, 4 if i == 0 else 2, 3,
                                               padding=1))
            setattr(self, f"reg{i}", nn.Conv2d(ch, 4, 3, padding=1))

    def forward(self, x):
        """x: (B, 3, H, W) float32, RGB * 255 - MEAN_RGB.  Returns the six
        heads' (softmaxed class scores (B, 2, h, w), offsets (B, 4, h, w))."""
        sources = []
        h = x
        for stage, (_, reps) in enumerate(VGG_CFG, start=1):
            for i in range(reps):
                h = F.relu(getattr(self, f"conv{stage}_{i + 1}")(h))
            if stage >= 3:
                sources.append(h)       # conv3_3, conv4_3, conv5_3
            # stage 3 pools with a pad of one on the bottom and right (the
            # flax ((0, 1), (0, 1))): ceil mode
            h = F.max_pool2d(h, 2, 2, ceil_mode=stage == 3)
        h = F.relu(self.fc7(F.relu(self.fc6(h))))
        sources.append(h)
        h = F.relu(self.conv6_2(F.relu(self.conv6_1(h))))
        sources.append(h)
        h = F.relu(self.conv7_2(F.relu(self.conv7_1(h))))
        sources.append(h)
        sources[0] = self.l2norm3(sources[0])
        sources[1] = self.l2norm4(sources[1])
        sources[2] = self.l2norm5(sources[2])

        outputs = []
        for i, src in enumerate(sources):
            cls = getattr(self, f"cls{i}")(src)
            reg = getattr(self, f"reg{i}")(src)
            if i == 0:      # max-out: background = max of the first 3
                bg = cls[:, :3].amax(dim=1, keepdim=True)
                cls = torch.cat([bg, cls[:, 3:]], dim=1)
            outputs.append((torch.softmax(cls, dim=1), reg))
        return outputs


def preprocess(images_uint8):
    """(B, H, W, 3) uint8 RGB (a tensor on the net's device) -> the net's
    (B, 3, H, W) input."""
    mean = torch.tensor(MEAN_RGB, device=images_uint8.device)
    return (images_uint8.float() - mean).permute(0, 3, 1, 2).contiguous()


def decode_detections(outputs, threshold=0.5):
    """Head outputs -> per frame, an (N, 5) float32 numpy array of [l, t,
    r, b, score] boxes (before NMS): the anchors whose face score exceeds
    ``threshold``, heads in order and positions row-major in each, as the
    JAX package's loop lists them.  Computed on the heads' device; the
    offsets' products in f32 and the anchor centres exact, as numpy
    computes them there."""
    per_frame = [[] for _ in range(outputs[0][0].shape[0])]
    for i, (cls, reg) in enumerate(outputs):
        stride, scale = STRIDES[i], SCALES[i]
        score = cls[:, 1]
        b, y, x = torch.nonzero(score > threshold, as_tuple=True)
        if not len(b):
            continue
        s = score[b, y, x]
        d = reg[b, :, y, x]                                  # (N, 4)
        cx = (x * stride).double() + stride / 2 \
            + (d[:, 0] * 0.1 * scale).double()
        cy = (y * stride).double() + stride / 2 \
            + (d[:, 1] * 0.1 * scale).double()
        w = (scale * torch.exp(d[:, 2] * 0.2)).double()
        h = (scale * torch.exp(d[:, 3] * 0.2)).double()
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2,
                             s.double()], dim=1).float().cpu().numpy()
        frame = b.cpu().numpy()
        for f in np.unique(frame):
            per_frame[f].append(boxes[frame == f])
    return [np.concatenate(p) if p else np.zeros((0, 5), np.float32)
            for p in per_frame]


def nms(boxes, iou_threshold=0.3):
    """Greedy NMS on (N, 5) [l, t, r, b, score] (the JAX package's, on the
    host)."""
    if len(boxes) == 0:
        return boxes
    order = boxes[:, 4].argsort()[::-1]
    keep = []
    while len(order):
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) \
            * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return boxes[keep]
