"""Kernel #9's device time over one whole paged leg of chip_smoke.py's
phase 9, on one card.

    python3 paged_leg_profile.py [--root DIR]

Imports paddle_tpu_torch from DIR (default: this checkout), so two
checkouts' kernels can be compared in one call on one card; the model,
the weights (seed 2026), the requests and the server are chip_smoke.py's
phase 9 (`_paged_programs`, `_paged_weights`, `_paged_requests`): the 32
requests served through PagedContinuousGenerationServer(steps_per_tick=8)
over 16 lanes. The leg runs once unprofiled (so every kernel is built
and warm), then once under torch.profiler. Each launch of
paged_decode_attention also keeps a device copy of its lanes' steps, so
each launch's device time is read beside the steps it served.

Prints, as its last line, one JSON object: the card and its power limit,
the profiled leg's wall and device busy ms, #9's launches and device ms
over the leg (in all, a launch on average, and by the launch's largest
lane step in bins of 32), and the histogram of the lanes' steps over the
leg's launches in bins of 32 (step -1, an idle lane, its own bin).
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
args = ap.parse_args()
sys.path.insert(0, os.path.abspath(args.root))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import paddle_tpu_torch as pf  # noqa: E402
from paddle_tpu_torch.inference import serving  # noqa: E402
from paddle_tpu_torch.ops.kernels import paged_attention as KPA  # noqa: E402

# this checkout's chip_smoke.py, whichever package DIR holds
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "chip_smoke.py"))
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)

BIN = 32


def main():
    if not torch.cuda.is_available():
        sys.exit("paged_leg_profile.py: no CUDA device")
    assert os.path.dirname(os.path.abspath(pf.__file__)).startswith(
        os.path.abspath(args.root)), pf.__file__
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    paged, _, _, startup, _ = C._paged_programs()
    gpu = pf.Executor(pf.CUDAPlace(0))
    scope = C._paged_weights(gpu, startup)
    distinct, ids = C._paged_requests()
    prompts = distinct[ids]

    kernel = KPA.paged_decode_attention
    steps = []

    def recording(q, pool_k, pool_v, block_tab, step, scale=1.0):
        steps.append(step.detach().clone())
        return kernel(q, pool_k, pool_v, block_tab, step, scale)

    # the wrapper counts its launches on the module's name, now this one
    recording.launches = 0

    def leg():
        srv = serving.PagedContinuousGenerationServer(
            paged, executor=gpu, scope=scope,
            steps_per_tick=C.PAGED["steps_per_tick"], start=False,
            radix_reuse=False)  # phase 9's leg: the hit and miss tiers
        return C._serve_continuous(srv, prompts)

    leg()
    KPA.paged_decode_attention = recording
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        _, st, _ = leg()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    KPA.paged_decode_attention = kernel
    launches = recording.launches
    assert st["completed"] == len(prompts), st["completed"]
    acts = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.time_range.elapsed_us() for e in acts) / 1e3
    mine = sorted((e for e in acts if "paged_decode" in e.name),
                  key=lambda e: e.time_range.start)
    assert len(mine) == launches == len(steps), (len(mine), launches,
                                                 len(steps))
    ms = np.array([e.time_range.elapsed_us() / 1e3 for e in mine])
    lanes = torch.stack(steps).cpu().numpy()          # [launches, R]
    top = lanes.max(1)
    by_step = {}
    for b in range(0, int(top.max()) + 1, BIN):
        sel = (top >= b) & (top < b + BIN)
        if sel.any():
            by_step[f"{b}-{b + BIN - 1}"] = dict(
                launches=int(sel.sum()), ms=float(ms[sel].sum()),
                mean_ms=float(ms[sel].mean()))
    flat = lanes.ravel()
    hist = {"-1": int((flat < 0).sum())}
    for b in range(0, int(flat.max()) + 1, BIN):
        hist[f"{b}-{b + BIN - 1}"] = int(((flat >= b)
                                          & (flat < b + BIN)).sum())
    res = dict(root=os.path.abspath(args.root), card=card,
               requests=len(prompts), ticks=st["device_telemetry"]["ticks"],
               profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
               paged_launches=launches, paged_ms=float(ms.sum()),
               paged_mean_ms=float(ms.mean()),
               paged_share=float(ms.sum()) / busy_ms,
               mean_lane_step=float(flat[flat >= 0].mean()),
               paged_ms_by_top_step=by_step, lane_steps=hist)
    print(f"paged leg ({args.root}) on {card}: {launches} launches of "
          f"paged_decode_attention, {ms.sum():.3f} ms of device time "
          f"({ms.mean() * 1e3:.2f} us a launch), {busy_ms:.1f} ms busy",
          flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
