"""Kernel #6 (``sdpa_short_bwd``, the short-sequence attention backward)
at the training shape [32, 8, 512, 64] in fp32, causal and not, on one
card.

    python3 sdpa_bwd_timing.py [--root DIR]

Imports paddle_tpu_torch from DIR (default: this checkout), so two
checkouts' kernels can be compared in one call on one card: run parent,
change, change, parent. Each case is first held against the plain
version on the same inputs (1e-5 of the largest |plain| grad, the gate
chip_smoke.py's phase 3 uses), then timed as chip_smoke.py times
a kernel (CUDA events, a sleep kernel covering the host's enqueue), the
best of 5 rounds of 20 launches.

Prints, as its last line, one JSON object: the root, the card and its
power limit, and per case the ms per launch and the largest error.
"""
import argparse
import json
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
args = ap.parse_args()
sys.path.insert(0, os.path.abspath(args.root))

import torch  # noqa: E402

import paddle_tpu_torch as pf  # noqa: E402
from paddle_tpu_torch.ops.kernels import attention as KA  # noqa: E402

SHAPE = (32, 8, 512, 64)
RTOL = 1e-5


def time_ms(fn, iters=20, warmup=3):
    """chip_smoke.py's `time_ms` (kept here: this script also runs
    against older checkouts, whose package lacks modules chip_smoke.py
    imports): mean device ms per call over `iters` back-to-back calls,
    CUDA events, a sleep kernel queued first so the card is timed and
    not the host's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of GPU clock cycles
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def main():
    if not torch.cuda.is_available():
        sys.exit("sdpa_bwd_timing.py: no CUDA device")
    assert os.path.dirname(os.path.abspath(pf.__file__)).startswith(
        os.path.abspath(args.root)), pf.__file__
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    b, h, t, d = SHAPE
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(SHAPE, device="cuda", generator=gen)
                  for _ in range(4))
    res = {}
    for causal in (False, True):
        _, p = KA.sdpa_short_plain(q, k, v, scale, causal, save_p=True)
        p = p.reshape(b * h, t, t).contiguous()
        got = KA.sdpa_short_bwd(q, k, v, p, g, scale, causal)
        want = KA.sdpa_short_bwd_plain(q, k, v, p, g, scale)
        err = max(float((x - w).abs().max() / w.abs().max())
                  for x, w in zip(got, want))
        assert err <= RTOL, (causal, err)
        ms = min(time_ms(lambda: KA.sdpa_short_bwd(q, k, v, p, g, scale,
                                                     causal))
                 for _ in range(5))
        res["causal" if causal else "full"] = dict(ms=ms, max_rel_err=err)
        print(f"sdpa_short_bwd fp32 {list(SHAPE)} causal {causal}: "
              f"{ms:.4f} ms, error {err:.3e} of the largest |plain| "
              f"({args.root}, {card})", flush=True)
    print(json.dumps(dict(root=os.path.abspath(args.root), card=card,
                          shape=list(SHAPE), **res)), flush=True)


if __name__ == "__main__":
    main()
