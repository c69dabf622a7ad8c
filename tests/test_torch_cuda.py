"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; elsewhere every test skips.  Run on
the card from the repository root, without the JAX test configuration:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from latentpose_tpu_torch.ops import adain as adain_op

pytestmark = pytest.mark.cuda

# (H*W, C) of the flagship generator's AdaINs at 256², plus odd sizes
SHAPES = [(16, 512), (1024, 512), (65536, 64), (25, 24), (9, 8)]
TOL = {torch.float32: 2e-4, torch.bfloat16: 1.6e-2}   # bf16: ~2 ulps


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(b, hw, c, dtype, device, broadcast=False):
    g = torch.Generator(device=device).manual_seed(hw * c)
    side = int(round(hw ** 0.5))
    x = torch.randn(b, side, side, c, generator=g, device=device) * 3 + 1
    rows = 1 if broadcast else b
    w, bias = (torch.randn(rows, c, generator=g, device=device)
               .expand(b, c) for _ in range(2))
    return x.to(dtype), w.to(dtype), bias.to(dtype)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c", SHAPES)
def test_adain_kernel_matches_plain(device, hw, c, dtype, relu):
    x, w, b = _inputs(4, hw, c, dtype, device)
    before = adain_op.adain.launches
    got = adain_op.adain(x, w, b, relu=relu)
    torch.cuda.synchronize()
    assert adain_op.adain.launches == before + 1
    want = adain_op.adain_reference(x, w, b, relu=relu)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_adain_kernel_broadcast_affine(device):
    """Row stride 0: one (C,) affine for the whole batch (InstanceNorm
    affine in ResBlock 'in')."""
    x, w, b = _inputs(3, 256, 128, torch.float32, device, broadcast=True)
    assert w.stride(0) == 0
    torch.testing.assert_close(adain_op.adain(x, w, b),
                               adain_op.adain_reference(x, w, b),
                               rtol=2e-4, atol=2e-4)


def test_adain_kernel_refuses_unvectorisable_channels(device):
    x, w, b = _inputs(2, 16, 6, torch.float32, device)
    with pytest.raises(ValueError, match="multiple"):
        adain_op.adain(x, w, b)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("hw,c", [(256, 512), (4096, 64)])
def test_adain_autograd_matches_autograd_through_plain(device, hw, c, relu):
    """Gradients of the kernel's autograd.Function against autograd through
    adain_reference (f32, TF32 off)."""
    x, w, b = _inputs(2, hw, c, torch.float32, device)
    grad = torch.randn_like(x)
    got, want = [], []
    for fn, out in ((adain_op.adain, got), (adain_op.adain_reference, want)):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        (fn(*leaves, relu=relu) * grad).sum().backward()
        out += [t.grad for t in leaves]
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3)


# conv_bn_fused: (M, Cin, Cout) of the ResNeXt-50 bottleneck links at 256²
# for 2 frames, plus ragged M and ragged Cout tiles
LINKS = [(2 * 4096, 128, 256), (2 * 1024, 256, 512), (2 * 256, 512, 1024),
         (2 * 64, 1024, 2048), (1000, 64, 200), (7, 8, 8)]
CONV_TOL = {torch.float32: 2e-4, torch.bfloat16: 1.6e-2}


def _link_inputs(m, cin, cout, dtype, device):
    g = torch.Generator(device=device).manual_seed(m + cin + cout)
    x = torch.randn(m, cin, generator=g, device=device) * 2 + 0.5
    w = torch.randn(cout, cin, generator=g, device=device) / cin ** 0.5
    scale = torch.rand(cin, generator=g, device=device) + 0.5
    offset = torch.randn(cin, generator=g, device=device) * 0.1
    return x.to(dtype), scale, offset, w.to(dtype).t()


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,cin,cout", LINKS)
def test_conv_bn_kernel_matches_plain(device, m, cin, cout, dtype, relu):
    from latentpose_tpu_torch.ops import conv_bn
    x, scale, offset, w = _link_inputs(m, cin, cout, dtype, device)
    before = conv_bn.bn_relu_conv1x1_stats.launches
    y, stats = conv_bn.bn_relu_conv1x1_stats(x, scale, offset, w, relu=relu)
    torch.cuda.synchronize()
    assert conv_bn.bn_relu_conv1x1_stats.launches == before + 1
    want_y, want_stats = conv_bn.bn_relu_conv1x1_stats_reference(
        x, scale, offset, w, relu=relu)
    assert y.shape == (m, cout) and y.dtype == dtype
    tol = CONV_TOL[dtype]
    ref = want_y.float().abs().max().item()
    torch.testing.assert_close(y.float() / ref, want_y.float() / ref,
                               rtol=tol, atol=tol)
    # the sums come from f32 accumulators in both versions
    torch.testing.assert_close(stats, want_stats, rtol=1e-4,
                               atol=1e-4 * want_stats.abs().max().item())


def test_conv_bn_kernel_refuses_what_it_does_not_take(device):
    from latentpose_tpu_torch.ops import conv_bn
    x, scale, offset, w = _link_inputs(64, 12, 16, torch.bfloat16, device)
    with pytest.raises(ValueError, match="multiple"):
        conv_bn.bn_relu_conv1x1_stats(x, scale, offset, w)
    x, scale, offset, w = _link_inputs(64, 16, 16, torch.float32, device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv_bn.bn_relu_conv1x1_stats(x.double(), scale.double(),
                                      offset.double(), w.double())
    with torch.no_grad():
        conv_bn.bn_relu_conv1x1_stats(x, scale, offset, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 3])
def test_adain_kernel_partly_resident_sample(device, batch, dtype):
    """(16384, 128): the cluster holds part of each sample in shared memory
    and streams the rest twice; batch 1 and 3 clusters."""
    assert not adain_op.plan_launch(16384, 128, 2).holds_sample
    x, w, b = _inputs(batch, 16384, 128, dtype, device)
    torch.testing.assert_close(adain_op.adain(x, w, b).float(),
                               adain_op.adain_reference(x, w, b).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [65, 129, 191])
def test_conv_bn_kernel_ragged_edges(device, m, dtype):
    """M just past a 64-row and a 128-row edge, and Cin below one K tile and
    not a multiple of it (24 bf16, 12 f32)."""
    from latentpose_tpu_torch.ops import conv_bn
    cin, cout = (24, 16) if dtype == torch.bfloat16 else (12, 8)
    x, scale, offset, w = _link_inputs(m, cin, cout, dtype, device)
    y, stats = conv_bn.bn_relu_conv1x1_stats(x, scale, offset, w)
    want_y, want_stats = conv_bn.bn_relu_conv1x1_stats_reference(
        x, scale, offset, w)
    tol = CONV_TOL[dtype]
    ref = want_y.float().abs().max().item()
    torch.testing.assert_close(y.float() / ref, want_y.float() / ref,
                               rtol=tol, atol=tol)
    torch.testing.assert_close(stats, want_stats, rtol=1e-4,
                               atol=1e-4 * want_stats.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_are_deterministic(device, dtype):
    """Fixed-order reductions: two calls give bitwise-equal results."""
    from latentpose_tpu_torch.ops import conv_bn
    x, w, b = _inputs(2, 65536, 64, dtype, device)
    assert torch.equal(adain_op.adain(x, w, b), adain_op.adain(x, w, b))
    x, scale, offset, w = _link_inputs(2 * 4096, 128, 256, dtype, device)
    with torch.no_grad():
        y1, s1 = conv_bn.bn_relu_conv1x1_stats(x, scale, offset, w)
        y2, s2 = conv_bn.bn_relu_conv1x1_stats(x, scale, offset, w)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,cin,cout", [(65, 128, 256), (191, 256, 64),
                                        (1000, 512, 1024), (129, 12, 8)])
def test_conv_bn_function_gradients_match_autograd_through_plain(
        device, m, cin, cout, relu):
    """The autograd.Function on the card (the kernel's forward, the plain
    backward) against autograd through the plain version, f32, TF32 off,
    ragged shapes: y, the stats and the gradients of x, scale, offset and
    conv3's weight through its view, within 2e-4 of each tensor's max."""
    from latentpose_tpu_torch.ops import conv_bn
    torch.backends.cuda.matmul.allow_tf32 = False
    x, scale, offset, w = _link_inputs(m, cin, cout, torch.float32, device)
    g = torch.Generator(device=device).manual_seed(m + cout)
    cot_y = torch.randn(m, cout, generator=g, device=device)
    cot_s = torch.randn(2, cout, generator=g, device=device) / m
    results = []
    for fn in (conv_bn.bn_relu_conv1x1_stats,
               conv_bn.bn_relu_conv1x1_stats_reference):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, scale, offset, w.t())]
        launches = conv_bn.bn_relu_conv1x1_stats.launches
        y, stats = fn(*leaves[:3], leaves[3].t(), relu=relu)
        grads = torch.autograd.grad((y, stats), leaves, (cot_y, cot_s))
        results.append((y, stats, *grads))
    assert conv_bn.bn_relu_conv1x1_stats.launches == launches   # the plain
    torch.cuda.synchronize()
    for got, want in zip(*results):
        ref = want.abs().max().item()
        assert (got - want).abs().max().item() <= 2e-4 * ref


def test_conv_bn_function_is_deterministic(device):
    """Under autograd too, two calls give bitwise-equal y and stats, and
    bitwise-equal gradients."""
    from latentpose_tpu_torch.ops import conv_bn
    x, scale, offset, w = _link_inputs(2 * 4096, 128, 256, torch.float32,
                                       device)
    out = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, scale, offset, w)]
        y, stats = conv_bn.bn_relu_conv1x1_stats(*leaves)
        out.append((y, stats, *torch.autograd.grad(
            (y.square().sum() + stats.sum()), leaves)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["colour_420", "colour_444", "grey"])
def test_image_loader_decodes_jpeg(device, tmp_path, kind):
    """The image loader's JPEG decoder where the card is (nvJPEG where
    libjpeg's headers are absent) against cv2's, on a smooth frame at its
    own size.  The loader upsamples and converts the decoded planes itself
    as libjpeg does (``tests/test_torch_data.py`` holds that part bit for
    bit), so the two differ by their inverse DCTs only, which the JPEG
    standard bounds: the luma (0.299 R + 0.587 G + 0.114 B) within 3/255,
    every channel within 6/255, and 1/255 on average.  Frames that do not
    decode are counted and zeroed."""
    cv2 = pytest.importorskip("cv2")
    import numpy as np
    from scipy.ndimage import uniform_filter
    from latentpose_tpu_torch.data import native_loader
    rng = np.random.RandomState(3)
    img = (uniform_filter(rng.rand(120, 88, 3), size=(9, 9, 1)) * 255
           ).astype(np.uint8)
    path = tmp_path / "f.jpg"
    params = [cv2.IMWRITE_JPEG_QUALITY, 95]
    if kind == "colour_444":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    cv2.imwrite(str(path), img[..., 0] if kind == "grey" else img, params)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1].astype(float)
    got = native_loader.decode(path).astype(float)
    assert got.shape == want.shape == (120, 88, 3)
    luma = np.abs((got - want) @ [0.299, 0.587, 0.114])
    diff = np.abs(got - want)
    print(f"JPEG decoder {native_loader.jpeg_decoder()}, {kind}: luma max "
          f"{luma.max():.3f}, channels max {diff.max():.0f} mean "
          f"{diff.mean():.4f} (of 255)")
    assert luma.max() <= 3 and diff.max() <= 6 and diff.mean() <= 1.0
    frames, failed = native_loader.NativeBatchLoader(2).load(
        [path, tmp_path / "missing.jpg", path], 64)
    assert failed == 1 and frames[0].max() > 0 and not frames[1].any()
    np.testing.assert_array_equal(frames[0], frames[2])


# --- int8 serving (ops/quant.py): the card's route is a library GEMM -------------

def _flagship_quant_shapes():
    from latentpose_tpu_torch.models.generators import (
        vector_pose_unsupervised_segmentation_noBottleneck as gen_mod)
    return gen_mod.quantized_conv_shapes()


@pytest.mark.parametrize("index", range(22))
def test_int8_card_route_is_bit_equal_to_plain(device, index):
    """Each of the flagship's 22 quantized convs at batch 2: the card's
    im2col + ``torch._int_mm`` against the exact float64 route, on the card
    and on the CPU; the bf16 epilogue of both accumulators."""
    from latentpose_tpu_torch.ops import quant
    name, cin, cout, k, side = _flagship_quant_shapes()[index]
    g = torch.Generator(device=device).manual_seed(index)
    x = torch.randn(2, cin, side, side, generator=g, device=device) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = torch.randn(cout, cin, k, k, generator=g, device=device) \
        .to(torch.bfloat16)
    xq, s_x = quant.quantize_dynamic(x)
    kq, s_k = quant.quantize_kernel_per_channel(w)
    before = quant.int8_conv.launches
    acc = quant.int8_conv(xq, kq, k // 2)
    torch.cuda.synchronize()
    assert quant.int8_conv.launches == before + 1
    assert acc.dtype == torch.int32 and acc.shape == (2, cout, side, side)
    assert torch.equal(acc, quant.int8_conv_reference(xq, kq, k // 2))
    cpu = quant.int8_conv_reference(xq.cpu(), kq.cpu(), k // 2)
    assert torch.equal(acc.cpu(), cpu), name
    assert torch.equal(
        quant.epilogue(acc, s_x, s_k, torch.bfloat16).cpu(),
        quant.epilogue(cpu, s_x.cpu(), s_k.cpu(), torch.bfloat16)), name


@pytest.mark.parametrize("quantize", ["int8", "int8_static"])
def test_int8_generator_forward_launches(device, quantize):
    """One forward of the flagship generator in int8: 22 int8 products on
    the card's route and 17 AdaIN kernel launches, finite frames."""
    import types
    from latentpose_tpu_torch.models.generators import (
        vector_pose_unsupervised_segmentation_noBottleneck as gen_mod)
    from latentpose_tpu_torch.ops import quant
    from latentpose_tpu_torch.ops.spectral_norm import quantized_convs
    args = types.SimpleNamespace(
        gen_padding="zero", out_channels=3, num_channels=64,
        max_num_channels=512, embed_channels=512, pose_embedding_size=256,
        gen_constant_input_size=4, gen_num_residual_blocks=2,
        image_size=256, quantize=quantize)
    gen = gen_mod.Wrapper.get_net(
        args, generator=torch.Generator().manual_seed(0)).to(device).eval()
    for conv in quantized_convs(gen).values():
        conv.act_absmax.fill_(4.0)
    g = torch.Generator(device=device).manual_seed(1)
    embeds, pose = (torch.randn(2, n, generator=g, device=device)
                    .to(torch.bfloat16) for n in (512, 256))
    quant.int8_conv.launches = adain_op.adain.launches = 0
    with torch.no_grad():
        rgbs, segm = gen(embeds, pose)
    torch.cuda.synchronize()
    assert quant.int8_conv.launches == 22
    assert adain_op.adain.launches == 17
    assert rgbs.shape == (2, 256, 256, 3) and torch.isfinite(rgbs).all()


@pytest.mark.parametrize("hw,size", [((150, 150), (112, 112)),
                                     ((38, 38), (112, 112)),
                                     ((150, 150), (16, 16)),
                                     ((64, 64), (16, 16))])
def test_eval_resizes_card_bit_equal_to_cpu(device, hw, size):
    """The eval harness's crop resizes (ops/resize.py) on the card: the
    same uint8 values as on the CPU."""
    from latentpose_tpu_torch.ops.resize import resize_area, resize_cubic
    g = torch.Generator().manual_seed(sum(hw) + sum(size))
    x = torch.randint(0, 256, (4, *hw, 3), generator=g, dtype=torch.uint8)
    assert torch.equal(resize_cubic(x.to(device), size).cpu(),
                       resize_cubic(x, size))
    if size[0] <= hw[1]:
        assert torch.equal(resize_area(x.to(device), size).cpu(),
                           resize_area(x, size))


def _seeded_eval(net, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                 generator=g)
            elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return net.eval()


def test_arcface_card_matches_cpu(device):
    """The published ArcFace-r100 tower, seeded, 8 crops at 112² (TF32
    off): within 1e-3 of the embedding's largest magnitude."""
    from latentpose_tpu_torch.eval.arcface import ArcFaceR100
    net = _seeded_eval(ArcFaceR100(), 5)
    x = torch.randint(0, 256, (8, 112, 112, 3),
                      generator=torch.Generator().manual_seed(6),
                      dtype=torch.uint8)
    tf32 = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = net(x)
            got = net.to(device)(x.to(device)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


def test_lpips_card_matches_cpu(device):
    """The unarmed AlexNet tower at 256² (TF32 off): 1e-3 relative."""
    from latentpose_tpu_torch.eval import lpips
    g = torch.Generator().manual_seed(7)
    a = torch.rand(4, 256, 256, 3, generator=g)
    b = (a + 0.1 * torch.randn(a.shape, generator=g)).clamp(0, 1)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = lpips.lpips_fn("", allow_random=True, device="cpu")[0](a, b)
        got = lpips.lpips_fn("", allow_random=True, device=device)[0](
            a, b).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.testing.assert_close(got, want, rtol=1e-3, atol=0)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_exported_drive_step_launches_the_kernel(device, tmp_path, compute):
    """A tiny drive step exported on the card (``cli/export.py``), saved and
    reloaded: it equals eager drive and launches the AdaIN kernel once for
    each of the generator's AdaINs a forward, through the operator."""
    import types
    from latentpose_tpu_torch import registry
    from latentpose_tpu_torch.cli import export as export_cli
    from latentpose_tpu_torch.runners import drive as drive_lib
    args = types.SimpleNamespace(
        generator="vector_pose_unsupervised_segmentation_noBottleneck",
        embedder="unsupervised_pose_separate_embResNeXt_segmentation",
        image_size=32, in_channels=3, out_channels=3, num_channels=8,
        max_num_channels=32, embed_channels=16, pose_embedding_size=8,
        gen_padding="zero", gen_constant_input_size=4,
        gen_num_residual_blocks=1, norm_layer="in", average_function="sum",
        compute_dtype=compute)
    g = torch.Generator().manual_seed(0)
    models = {k: registry.load_wrapper(k + "s", getattr(args, k))
              .get_net(args, generator=g).to(device).eval()
              for k in ("embedder", "generator")}
    state = {"finetune_embedding": torch.rand(1, 16, generator=g).to(device)}
    frames = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8,
                           generator=g).to(device)
    exported = export_cli.export_serving_artifact(models, state, args, 4,
                                                  torch.uint8)
    torch.export.save(exported, str(tmp_path / "a.pt2"))
    serve = export_cli.load_serving_artifact(tmp_path / "a.pt2")
    want = drive_lib.make_drive_fn(models, args)(state, frames)
    adain_op.adain.launches = 0
    got = serve(frames)
    torch.cuda.synchronize()
    assert adain_op.adain.launches == \
        len(models["generator"].adain_features) == 9
    for a, b in zip(got, want):
        assert a.device == device and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)


@pytest.mark.parametrize("flags", [[], ["--grad_dtype", "bfloat16"]],
                         ids=["f32", "bf16_wire"])
def test_train_cli_takes_a_step_in_a_world_of_one_nccl_rank(
        device, tmp_path, flags):
    """``cli.train`` as a torchrun rank of a world of 1 on the card: NCCL's
    group, the gradient reduce (f32, or bf16 on the wire), rank 0's save."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    argv = ["--config_name", "default", "--dataloader", "synthetic",
            "--device", "cuda", "--allow_random_vgg", "--image_size", "32",
            "--num_channels", "8", "--max_num_channels", "32",
            "--embed_channels", "32", "--pose_embedding_size", "8",
            "--dis_num_blocks", "3", "--gen_num_residual_blocks", "1",
            "--batch_size", "2", "--synthetic_num_labels", "2",
            "--num_enc_frames", "2", "--num_epochs", "1",
            "--experiments_dir", str(tmp_path), *flags]
    proc = subprocess.run(
        [sys.executable, "-m", "latentpose_tpu_torch.cli.train", *argv],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "iteration 0:" in proc.stderr
    assert len(list(tmp_path.glob("*/checkpoints/model_00000001.ckpt"))) == 1
