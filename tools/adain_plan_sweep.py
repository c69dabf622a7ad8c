#!/usr/bin/env python3
"""Device time of AdaIN launch plans on one NVIDIA GPU.

    python3 tools/adain_plan_sweep.py [--batch 32]

For each of the flagship generator's 7 AdaIN shapes in bf16, the kernel
(``latentpose_tpu_torch/csrc/adain_fused.cu``) runs under the plan that
``ops/adain.py`` picks and under alternatives: every cluster size cap, and,
where a sample does not fit its cluster's shared memory, other resident
sizes.  Each plan is checked against the plain version and timed as device
milliseconds per call from a CUDA graph of 20 launches (no host time between
launches).  One line per plan; ``*`` marks the plan the wrapper uses.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from latentpose_tpu_torch.ops import adain  # noqa: E402

SHAPES = [(16, 512), (64, 512), (256, 512), (1024, 512), (4096, 256),
          (16384, 128), (65536, 64)]
RESIDENT_KB = (160, 96, 64, 40, 16)


def graph_ms(launch, n=20, reps=5):
    """Device ms per launch: ``n`` launches captured in a CUDA graph,
    replayed ``reps`` times between CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def candidates(hw, c):
    """The wrapper's plan first, then the alternatives."""
    plans = [adain.plan_launch(hw, c, 2, cap) for cap in (16, 8, 4, 2, 1)]
    base = plans[0]
    if not base.holds_sample:
        fits = (adain.SMEM_LIMIT - adain.smem_bytes(c, 2, 0)) // (c * 2)
        for kb in (None, *RESIDENT_KB):
            res = fits if kb is None else min(fits, (kb << 10) // (c * 2))
            plans.append(adain.Plan(base.cluster, base.block_pixels, res,
                                    max(1, -(-res // adain.CHUNKS)),
                                    adain.smem_bytes(c, 2, res)))
    return list(dict.fromkeys(plans))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=32)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("adain_plan_sweep: needs an NVIDIA GPU")
    fn, occupancy = adain.kernel_entry()
    stream = torch.cuda.current_stream
    g = torch.Generator(device="cuda").manual_seed(1)
    for hw, c in SHAPES:
        side = int(round(hw ** 0.5))
        x = (torch.randn(args.batch, side, side, c, generator=g,
                         device="cuda") * 3 + 1).bfloat16()
        w, b = (torch.randn(args.batch, c, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        out = torch.empty_like(x)
        want = adain.adain_reference(x, w, b)
        bound = 2 * x.numel() * 2 / 3.35e12 * 1e3
        chosen, _ = adain.card_plan(hw, c, torch.bfloat16)
        for plan in candidates(hw, c):
            count = ctypes.c_int(0)
            if occupancy(plan.cluster, plan.smem, 1, ctypes.byref(count)) \
                    or count.value == 0:
                print(f"{hw}x{c} {plan}: does not fit the card", flush=True)
                continue
            arr = (ctypes.c_int * 8)(hw, c, *plan, 1)

            def launch():
                err = fn(x.data_ptr(), w.data_ptr(), w.stride(0),
                         b.data_ptr(), b.stride(0), out.data_ptr(),
                         args.batch, arr, 1, 1e-4, stream().cuda_stream)
                if err:
                    raise RuntimeError(f"cudaError_t {err}")

            launch()
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), want.float(),
                                       rtol=1.6e-2, atol=1.6e-2)
            ms = graph_ms(launch)
            print(f"{'*' if plan == chosen else ' '} {hw}x{c} B={args.batch} "
                  f"cluster={plan.cluster} block_pixels={plan.block_pixels} "
                  f"resident={plan.resident} smem={plan.smem} "
                  f"clusters_at_once={count.value} device_ms={ms:.4f} "
                  f"share={bound / ms:.3f}", flush=True)


if __name__ == "__main__":
    main()
