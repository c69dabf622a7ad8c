"""Augmentation of the (driver, target, segmentation) triplet on the batch's
device (port of ``latentpose_tpu/data/augmentation.py``, NHWC like it).

The reference augments on the host with imgaug: a SomeOf(0..5) bag of 11
pixelwise ops and a 50 % affine scale on the driver, and a 50 % affine shift
applied alike to driver, target and segmentation.  As in the JAX package each
op gets its own per-sample coin with the bag's marginal (2.5 / 11), and the
affine warps are separable bilinear resamples.

Each op is split into a **draw** and a deterministic **apply**:

- :class:`Draw` holds the two sources of randomness.  Per-sample parameters
  (coins, strengths, JPEG quality, affine scale and shift) come from a CPU
  ``torch.Generator``, so that a card run and a CPU run from one seed see the
  same augmentation.  Per-pixel fields (additive noise, elastic
  displacement, the blobby edge mask) come from a generator on the batch's
  device: on the card they differ from a CPU run's.
- ``draw_<op>(draw, shape)`` returns the op's draws as a dict, and
  ``<op>(images, **draws)`` applies them.  The JAX ops draw the same
  quantities from their keys; the distributions match, not the bits.

Images are (B, H, W, C) float in [0, 1].
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from latentpose_tpu_torch.ops.resample import affine_resample
from latentpose_tpu_torch.parallel.mesh import take_rows

# Per-op application probability: the reference's SomeOf(0..5) over 11 ops
# has a per-op marginal of 2.5 / 11; each op gets an independent coin.
OP_P = 2.5 / 11.0


class Draw:
    """The random numbers of one augmentation pass: per-sample draws from
    the CPU generator ``gen``, moved to ``device``; per-pixel fields from
    ``field_gen``, a generator on ``device``."""

    def __init__(self, gen, field_gen, device):
        self.gen, self.field_gen = gen, field_gen
        self.device = torch.device(device)

    def coin(self, b, p):
        return (torch.rand(b, generator=self.gen) < p).to(self.device)

    def uniform(self, b, low=0.0, high=1.0):
        u = torch.rand(b, generator=self.gen)
        return (low + (high - low) * u).to(self.device)

    def field_uniform(self, shape, low=0.0, high=1.0):
        u = torch.rand(shape, generator=self.field_gen, device=self.device)
        return low + (high - low) * u

    def field_normal(self, shape):
        return torch.randn(shape, generator=self.field_gen,
                           device=self.device)


def step_key(seed: int, step: int, rank: int = 0) -> int:
    """The seed of train step ``step``'s draws in a run seeded ``seed``: a
    function of the two alone, so a resumed run draws as an unbroken one
    does; ``rank`` > 0: a rank's own draw (the explicit data-parallel
    regime; rank 0 draws what one process draws)."""
    return (int(seed) * 1000003 + int(step)
            + int(rank) * 0x9E3779B97F4A7C15) % (2 ** 62)


def step_draw(seed: int, step: int, device, rank: int = 0) -> Draw:
    """The draw of train step ``step`` of a run seeded ``seed``
    (:func:`step_key`)."""
    key = step_key(seed, step, rank)
    gen = torch.Generator().manual_seed(key)
    field_gen = torch.Generator(torch.device(device)).manual_seed(key)
    return Draw(gen, field_gen, device)


def _col(v):
    """(B,) -> (B, 1, 1, 1), to broadcast over NHWC."""
    return v.reshape(-1, 1, 1, 1)


def _blend(apply, augmented, original):
    return torch.where(_col(apply), augmented, original)


def _edge_pad(x, pad, dims=(1, 2)):
    """Edge (replicate) padding of ``pad`` pixels on each given dim."""
    for dim in dims:
        n = x.shape[dim]
        idx = torch.arange(-pad, n + pad, device=x.device).clamp(0, n - 1)
        x = x.index_select(dim, idx)
    return x


def _shifted(xp, dy, dx, h, w):
    return xp[:, dy:dy + h, dx:dx + w, :]


# --- the 11 pixelwise ops -----------------------------------------------------

def draw_gaussian_blur(draw, shape):
    b = shape[0]
    return {"apply": draw.coin(b, OP_P), "alpha": draw.uniform(b)}


def gaussian_blur(images, apply, alpha):
    """iaa.GaussianBlur((0, 1)) family: a fixed 5-tap [1 4 6 4 1] / 16 blur
    (edge padded) blended in with strength ``alpha``."""
    taps = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)

    def blur1d(x, dim):
        xp = _edge_pad(x, 2, (dim,))
        n = x.shape[dim]
        out = 0.0
        for i, t in enumerate(taps):
            out = out + t * xp.narrow(dim, i, n)
        return out

    blurred = blur1d(blur1d(images, 1), 2)
    out = images + (blurred - images) * _col(alpha)
    return _blend(apply, out, images)


def draw_sharpen(draw, shape):
    b = shape[0]
    return {"apply": draw.coin(b, OP_P), "alpha": draw.uniform(b),
            "lightness": draw.uniform(b, 1.0, 1.5)}


def sharpen(images, apply, alpha, lightness):
    """iaa.Sharpen(alpha=(0, 1), lightness=(1, 1.5)) family."""
    _, h, w, _ = images.shape
    xp = _edge_pad(images, 1)
    box = 0.0
    for dy in range(3):
        for dx in range(3):
            box = box + _shifted(xp, dy, dx, h, w)
    mean3 = box / 9.0
    sharp = images * _col(lightness) + (images - mean3) * 1.0
    out = images * (1 - _col(alpha)) + sharp * _col(alpha)
    return _blend(apply, out.clamp(0, 1), images)


def draw_emboss(draw, shape):
    b = shape[0]
    return {"apply": draw.coin(b, OP_P), "alpha": draw.uniform(b),
            "strength": draw.uniform(b, 0.0, 0.5)}


def emboss(images, apply, alpha, strength):
    """iaa.Emboss(alpha=(0, 1), strength=(0, 0.5)): the 3x3 kernel
    [[-1-s, -s, 0], [-s, 1, s], [0, s, 1+s]] blended with the identity."""
    _, h, w, _ = images.shape
    s = _col(strength)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    kernel = [[-1.0 - s, -s, zero], [-s, one, s], [zero, s, 1.0 + s]]
    xp = _edge_pad(images, 1)
    effect = 0.0
    for dy in range(3):
        for dx in range(3):
            effect = effect + kernel[dy][dx] * _shifted(xp, dy, dx, h, w)
    out = images + (effect - images) * _col(alpha)
    return _blend(apply, out.clamp(0, 1), images)


BLOB_CELL = 8     # the blobby mask's resolution: 1 / 8 of the image's


def draw_edge_detect_blobby(draw, shape):
    b, h, w, _ = shape
    return {"apply": draw.coin(b, OP_P),
            "alpha": draw.uniform(b, 0.0, 0.15),
            "mask": draw.field_uniform(
                (b, max(h // BLOB_CELL, 1), max(w // BLOB_CELL, 1), 1))}


def edge_detect_blobby(images, apply, alpha, mask):
    """iaa.BlendAlphaSimplexNoise(iaa.EdgeDetect(alpha=(0, 0.15))): the
    edge image clip(x + a (lap(x) - x)) blended in through a blobby mask,
    a U(0, 1) field at 1/8 resolution upsampled bilinearly."""
    _, h, w, _ = images.shape
    xp = _edge_pad(images, 1)
    lap = (xp[:, :-2, 1:-1] + xp[:, 2:, 1:-1] + xp[:, 1:-1, :-2]
           + xp[:, 1:-1, 2:] - 4.0 * images)
    edged = (images + _col(alpha) * (lap - images)).clamp(0, 1)
    up = F.interpolate(mask.permute(0, 3, 1, 2), size=(h, w),
                       mode="bilinear", align_corners=False)
    out = images + up.permute(0, 2, 3, 1) * (edged - images)
    return _blend(apply, out, images)


def draw_additive_noise(draw, shape):
    b = shape[0]
    return {"apply": draw.coin(b, OP_P),
            "scale": draw.uniform(b, 0.0, 0.05),
            "noise": draw.field_normal(tuple(shape))}


def additive_noise(images, apply, scale, noise):
    """iaa.AdditiveGaussianNoise(scale=(0, 0.05 * 255)): per-sample sigma."""
    return _blend(apply, (images + noise * _col(scale)).clamp(0, 1), images)


def draw_brightness(draw, shape):
    b = shape[0]
    return {"apply": draw.coin(b, OP_P),
            "add": draw.uniform(b, -10.0 / 255.0, 10.0 / 255.0)}


def brightness(images, apply, add):
    """iaa.Add((-10, 10))."""
    return _blend(apply, (images + _col(add)).clamp(0, 1), images)


def draw_multiply(draw, shape):
    b = shape[0]
    return {"apply": draw.coin(b, OP_P), "mul": draw.uniform(b, 0.5, 1.5)}


def multiply(images, apply, mul):
    """iaa.Multiply((0.5, 1.5))."""
    return _blend(apply, (images * _col(mul)).clamp(0, 1), images)


def draw_contrast(draw, shape):
    b = shape[0]
    return {"apply": draw.coin(b, OP_P), "linear": draw.coin(b, 0.5),
            "contrast": draw.uniform(b, 0.75, 1.25),
            "gain": draw.uniform(b, 3.0, 11.0)}


def contrast(images, apply, linear, contrast, gain):
    """OneOf(LinearContrast((0.75, 1.25)), SigmoidContrast(cutoff 0.5,
    gain (3, 11))): a fair coin per sample picks the linear map or the
    sigmoid."""
    lin = (images - 0.5) * _col(contrast) + 0.5
    sig = torch.sigmoid(_col(gain) * (images - 0.5))
    out = torch.where(_col(linear), lin, sig)
    return _blend(apply, out.clamp(0, 1), images)


def draw_saturation(draw, shape):
    b = shape[0]
    return {"apply": draw.coin(b, OP_P),
            "shift": draw.uniform(b, -20.0 / 255.0, 20.0 / 255.0)}


def saturation(images, apply, shift):
    """AddToSaturation((-20, 20)) family: scale the distance from the grey
    by 1 + 5 shift."""
    gray = images.mean(dim=-1, keepdim=True)
    out = gray + (images - gray) * (1.0 + _col(shift) * 5.0)
    return _blend(apply, out.clamp(0, 1), images)


_JPEG_LUMA_Q = np.asarray([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)
_JPEG_CHROMA_Q = np.full((8, 8), 99, np.float32)
_JPEG_CHROMA_Q[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                          [24, 26, 56, 99], [47, 66, 99, 99]]


def _dct8(device):
    k = torch.arange(8, dtype=torch.float32, device=device)
    m = math.sqrt(2.0 / 8.0) * torch.cos(
        math.pi * (2.0 * k[None, :] + 1.0) * k[:, None] / 16.0)
    m[0] *= 1.0 / math.sqrt(2.0)
    return m


def _jpeg_quantize_plane(plane, table):
    """plane (B, H, W) in [0, 255], table (B, 1, 1, 8, 8): 8x8 DCT-II,
    quantise, dequantise, inverse DCT."""
    b, h, w = plane.shape
    m = _dct8(plane.device).to(plane.dtype)
    blocks = plane.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    coef = torch.einsum("ij,bhwjk,lk->bhwil", m, blocks - 128.0, m)
    coef = torch.round(coef / table) * table
    rec = torch.einsum("ji,bhwjk,kl->bhwil", m, coef, m) + 128.0
    return rec.permute(0, 1, 3, 2, 4).reshape(b, h, w)


def jpeg_roundtrip(images, quality):
    """JPEG encode and decode: YCbCr, 8x8 DCT quantisation with libjpeg's
    quality-scaled tables, 4:2:0 chroma where the size allows.
    images (B, H, W, 3) in [0, 1]; quality (B,) in [1, 100]."""
    b, h, w, _ = images.shape
    q = quality.float().reshape(b, 1, 1)
    scale = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)

    def table(base):
        base = torch.from_numpy(base).to(images.device)
        return torch.clamp(torch.floor((base * scale[..., None, None] + 50.0)
                                       / 100.0), 1.0, 255.0)

    x = images * 255.0
    r, g, bl = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * bl
    cb = -0.168736 * r - 0.331264 * g + 0.5 * bl + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * bl + 128.0
    y = _jpeg_quantize_plane(y, table(_JPEG_LUMA_Q))
    chroma = table(_JPEG_CHROMA_Q)
    if h % 16 == 0 and w % 16 == 0:          # 4:2:0
        def sub(c):
            return c.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

        def up(c):
            return c.repeat_interleave(2, 1).repeat_interleave(2, 2)

        cb = up(_jpeg_quantize_plane(sub(cb), chroma))
        cr = up(_jpeg_quantize_plane(sub(cr), chroma))
    else:
        cb = _jpeg_quantize_plane(cb, chroma)
        cr = _jpeg_quantize_plane(cr, chroma)
    cb, cr = cb - 128.0, cr - 128.0
    out = torch.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr,
                       y + 1.772 * cb], dim=-1) / 255.0
    return out.clamp(0, 1)


def draw_jpeg_artifacts(draw, shape):
    b = shape[0]
    return {"apply": draw.coin(b, OP_P),
            "quality": draw.uniform(b, 70.0, 99.0)}


def jpeg_artifacts(images, apply, quality):
    """iaa.JpegCompression((70, 99)); sizes that are not multiples of 8 are
    left as they are."""
    _, h, w, _ = images.shape
    if h % 8 or w % 8:
        return images
    return _blend(apply, jpeg_roundtrip(images, quality), images)


ELASTIC_ALPHA = (0.5, 3.5)


def draw_elastic(draw, shape):
    b, h, w, _ = shape
    return {"apply": draw.coin(b, OP_P * 0.5),
            "alpha": draw.uniform(b, *ELASTIC_ALPHA),
            "field": draw.field_uniform((b, h, w, 2), -1.0, 1.0)}


def displace_axis_bilinear(images, disp, dim, max_disp):
    """Bilinear warp along one spatial dim by ``disp`` (B, H, W) pixels,
    |disp| <= max_disp, edge clamped: a sum of 2 max_disp + 1 shifted
    copies weighted by the hat relu(1 - |disp - d|)."""
    n = images.shape[dim]
    xp = _edge_pad(images, max_disp, (dim,))
    out = torch.zeros_like(images)
    for d in range(-max_disp, max_disp + 1):
        wgt = torch.clamp(1.0 - (disp - d).abs(), min=0.0)
        out = out + wgt[..., None] * xp.narrow(dim, max_disp + d, n)
    return out


def elastic(images, apply, alpha, field):
    """sometimes(iaa.ElasticTransformation(alpha=(0.5, 3.5), sigma=0.15)):
    per-pixel displacements U(-1, 1) alpha, applied along x then y (sigma
    0.15 leaves imgaug's smoothing of the field a near-identity)."""
    disp = field * alpha.reshape(-1, 1, 1, 1)
    max_disp = int(np.ceil(ELASTIC_ALPHA[1]))
    out = displace_axis_bilinear(images, disp[..., 0], 2, max_disp)
    out = displace_axis_bilinear(out, disp[..., 1], 1, max_disp)
    return _blend(apply, out, images)


# (name, draw, apply) in the JAX package's order
PIXELWISE_OPS = (
    ("gaussian_blur", draw_gaussian_blur, gaussian_blur),
    ("sharpen", draw_sharpen, sharpen),
    ("emboss", draw_emboss, emboss),
    ("edge_detect_blobby", draw_edge_detect_blobby, edge_detect_blobby),
    ("additive_noise", draw_additive_noise, additive_noise),
    ("brightness", draw_brightness, brightness),
    ("multiply", draw_multiply, multiply),
    ("contrast", draw_contrast, contrast),
    ("saturation", draw_saturation, saturation),
    ("jpeg_artifacts", draw_jpeg_artifacts, jpeg_artifacts),
    ("elastic", draw_elastic, elastic),
)


def draw_pixelwise(draw, shape):
    """{op name: draws} for every pixelwise op."""
    return {name: draw_op(draw, shape) for name, draw_op, _ in PIXELWISE_OPS}


def pixelwise_augment(images, draws):
    """Every op in order, each firing per sample on its own coin."""
    for name, _, op in PIXELWISE_OPS:
        images = op(images, **draws[name])
    return images


# --- affine --------------------------------------------------------------------

def sample_affine_params(draw, batch, use_scale, use_shift):
    """Per-sample (sx, sy, tx, ty): scale U(0.8, 1.2) with p 0.5, shift
    U(-0.05, 0.05) of the side (2x that in grid units) with p 0.5."""
    dev = draw.device
    sx = sy = torch.ones(batch, device=dev)
    tx = ty = torch.zeros(batch, device=dev)
    if use_scale:
        apply = draw.coin(batch, 0.5)
        sx = torch.where(apply, draw.uniform(batch, 0.8, 1.2), sx)
        sy = torch.where(apply, draw.uniform(batch, 0.8, 1.2), sy)
    if use_shift:
        apply = draw.coin(batch, 0.5)
        tx = torch.where(apply, draw.uniform(batch, -0.05, 0.05) * 2.0, tx)
        ty = torch.where(apply, draw.uniform(batch, -0.05, 0.05) * 2.0, ty)
    return sx, sy, tx, ty


def apply_affine(images, sx, sy, tx, ty):
    """Bilinear resample on the affine grid, reflection at the borders;
    scale > 1 zooms in (imgaug's sense)."""
    return affine_resample(images, sx, sy, tx, ty)


# --- the triplet -----------------------------------------------------------------

def draw_triplet(draw, shape, use_pixelwise=False, use_scale=False,
                 use_shift=False):
    """The draws of :func:`augment_triplet` for a driver batch of
    ``shape``."""
    b = shape[0]
    return {
        "pixelwise": draw_pixelwise(draw, shape) if use_pixelwise else None,
        "scale": sample_affine_params(draw, b, True, False)
        if use_scale else None,
        "shift": sample_affine_params(draw, b, False, True)
        if use_shift else None,
    }


def augment_triplet(driver, target, segm, draws):
    """The reference's ``augment_triplet``: the driver gets the pixelwise ops
    and the scale; the one shift moves driver, target and segmentation
    alike.  driver, target (B, H, W, 3); segm (B, H, W, 1)."""
    if draws["pixelwise"] is not None:
        driver = pixelwise_augment(driver, draws["pixelwise"])
    if draws["scale"] is not None:
        driver = apply_affine(driver, *draws["scale"])
    if draws["shift"] is not None:
        driver, target, segm = (apply_affine(x, *draws["shift"])
                                for x in (driver, target, segm))
    return driver, target, segm


def augment_data_dict(batch, draw, use_pixelwise=False, use_scale=False,
                      use_shift=False, rows=None, global_size=None):
    """:func:`augment_triplet` on a train batch (driver, target and
    segmentation with a leading frame axis of 1), drawing from ``draw``;
    the batch as it is when every switch is off or, as in the JAX package,
    when it has no segmentation (the landmark datasets).  ``rows`` (a
    LongTensor): the batch is these rows of a global batch of
    ``global_size`` rows, and takes these rows of the global batch's draws
    (a rank's part of the default data-parallel regime's draw)."""
    needed = {"pose_input_rgbs", "target_rgbs", "real_segm"}
    if not (use_pixelwise or use_scale or use_shift) \
            or not needed <= set(batch):
        return batch
    driver = batch["pose_input_rgbs"][:, 0]
    target, segm = batch["target_rgbs"], batch["real_segm"]
    target = target[:, 0] if target.dim() > 4 else target
    segm = segm[:, 0] if segm.dim() > 4 else segm
    shape = tuple(driver.shape)
    if rows is not None:
        shape = (global_size,) + shape[1:]
    draws = draw_triplet(draw, shape, use_pixelwise, use_scale, use_shift)
    if rows is not None:
        draws = take_rows(draws, rows)
    driver, target, segm = augment_triplet(driver, target, segm, draws)
    return {**batch, "pose_input_rgbs": driver[:, None],
            "target_rgbs": target[:, None], "real_segm": segm[:, None]}
