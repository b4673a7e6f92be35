"""Kernels #12 and #13 in bf16 (``ffn_block_fwd_bf16``,
``ffn_block_bwd_bf16``) and the training legs around them, from one
checkout, on one card.

    python3 ffn_bf16_timing.py [--root DIR]

Imports DIR's ``chip_smoke.py`` and ``paddle_tpu_torch`` (default: this
checkout), so that two checkouts compare in one call on one card: run
parent, change, change, parent, each in its own process. It times #12
and #13 at x [64, 256, 512] and at the bench's [128, 256, 512], F 2048,
as chip_smoke.py times a kernel (CUDA events behind a sleep kernel), the
best of 3 rounds of 10 launches. Then it runs DIR's chip_smoke.py
training legs, each with its own gates: phase 5's fp32 leg (seq 256,
batch 64), the bf16 leg at the bench's settings (seq 256, batch 128),
phase 8's fp32 fused leg (seq 256, batch 64) and the bf16 fused leg (seq
256, batch 128, #10-#13 in bf16).

Prints, as its last line, one JSON object: the root, the card and its
power limit, the kernels' ms, and per leg the captured (run_steps) and
eager step ms, busy ms, idle share and eager peak memory.
"""
import argparse
import importlib
import json
import os
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
args = ap.parse_args()
ROOT = os.path.abspath(args.root)
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def best_ms(cs, fn):
    return min(cs.time_ms(fn, iters=10) for _ in range(3))


def kernels(cs):
    """#12 and #13 in bf16 at batch 64 and 128 (seq 256, D 512, F
    2048)."""
    kff = cs.KFF
    res = {}
    for b in (64, 128):
        a = {k: v.to(torch.bfloat16) for k, v in cs._fused_inputs(
            b, 256, 512, 2048, seed=120 + b).items()}
        x, g, w1, b1, w2, b2 = (a[k] for k in ("x", "g", "w1", "b1", "w2",
                                               "b2"))
        fwd = best_ms(cs, lambda: kff._ffn_block_launch(x, w1, b1, w2, b2))
        bwd = best_ms(cs, lambda: kff.ffn_block_bwd(x, w1, b1, w2, g))
        prods = 2 * b * 256 * 512 * 2048  # one [N, D] x [D, F] product
        res[b] = dict(ffn_block_ms=fwd, ffn_block_bwd_ms=bwd,
                      ffn_block_tflops=3 * prods / fwd / 1e9,
                      ffn_block_bwd_tflops=8 * prods / bwd / 1e9)
        cs.log(f"ffn_bf16_timing [{b},256,512] F 2048: #12 {fwd:.4f} ms "
               f"({res[b]['ffn_block_tflops']:.1f} TFLOP/s as run), #13 "
               f"{bwd:.4f} ms ({res[b]['ffn_block_bwd_tflops']:.1f})")
        del a, x, g
    return res


def leg(res):
    rs = res["run_steps"]
    return dict(run_steps_ms=rs["step_ms"], eager_ms=res["step_ms"],
                busy_ms=res["profile"]["device_busy_ms"],
                run_steps_busy_ms=rs["busy_ms_per_step"],
                idle_share=res["profile"]["idle_share"],
                run_steps_idle_share=rs["profile"]["idle_share"],
                peak_gib=res["peak_memory_bytes"] / 2 ** 30)


def main():
    if not torch.cuda.is_available():
        sys.exit("ffn_bf16_timing.py: no CUDA device")
    cs = importlib.import_module("chip_smoke")
    assert os.path.dirname(os.path.abspath(cs.__file__)) == ROOT, cs.__file__
    assert os.path.dirname(os.path.abspath(cs.pf.__file__)).startswith(ROOT)
    name, _, card = cs.phase_device()
    cs.phase_build()
    out = dict(root=ROOT, card=card, kernels=kernels(cs))
    _, fp32 = cs.phase_train(name, card, 256, 64)
    _, bf16 = cs.phase_train_bf16(name, card, 256, 128)
    _, fused = cs.phase_train_fused(name, card, fp32)
    _, bf16_fused = cs.phase_train_bf16(name, card, 256, 128, fused=True)
    out["legs"] = {"fp32 256x64": leg(fp32), "bf16 256x128": leg(bf16),
                   "fp32 fused 256x64": leg(fused),
                   "bf16 fused 256x128": leg(bf16_fused)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
