"""The host's time for one call of #1's wrapper (``KL.layer_norm``) and
of its launch alone (``KL._launch``, without the autograd Function
around it) at a paged tick's rows, [17, 512] fp32, and at the
predictor's bf16 [4096, 512], on one card.

    python3 ln_host_timing.py [--root DIR] [--calls N]
                              [--against PARENT --pairs P]

Imports paddle_tpu_torch from DIR (default: this checkout). With
``--against``, it compares two checkouts in one call on one card: it
runs itself P times (default 10) on each of DIR and PARENT, each run in
its own process, alternating which of the pair runs first, and prints
per case and call each side's median of the runs' best, the quartile
spread of PARENT's runs, and the pairs in which DIR was faster. Each case is first held against the
plain version (1e-5 on fp32; the largest bf16 error printed), then
called N times back to back (default 5000) with no synchronisation
between calls, timed by ``time.perf_counter`` around the loop, in 7
rounds (their best and median are printed). The kernel takes a few microseconds on the card and the
wrapper tens on the host, so the loop measures the host: what a
decode tick pays on the host for each #1 it runs.

Prints, as its last line, one JSON object: the root, the card and its
power limit, and per case and call the host us per call of each
round.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
ap.add_argument("--calls", type=int, default=5000)
ap.add_argument("--against")
ap.add_argument("--pairs", type=int, default=10)
args = ap.parse_args()
sys.path.insert(0, os.path.abspath(args.root))

import torch  # noqa: E402

import paddle_tpu_torch as pf  # noqa: E402
from paddle_tpu_torch.ops.kernels import layer_norm as KL  # noqa: E402

CASES = ((17, 512, torch.float32), (4096, 512, torch.bfloat16))


def _run(root):
    """One run of this script on `root`: its last line's cases."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--root", root,
         "--calls", str(args.calls)], capture_output=True, text=True,
        check=True).stdout
    return json.loads(out.strip().splitlines()[-1])["cases"]


def compare():
    """DIR against PARENT over `args.pairs` pairs of runs."""
    if not torch.cuda.is_available():
        sys.exit("ln_host_timing.py: no CUDA device")
    sides = {"change": os.path.abspath(args.root),
             "parent": os.path.abspath(args.against)}
    best = {"change": [], "parent": []}
    for i in range(args.pairs):
        for side in (("parent", "change") if i % 2 else
                     ("change", "parent")):
            best[side].append(_run(sides[side]))
    res = {}
    for case in best["change"][0]:
        for fn in ("layer_norm", "_launch"):
            runs = {side: [r[case][fn]["best_us"] for r in best[side]]
                    for side in best}
            par = sorted(runs["parent"])
            q = len(par) // 4
            res[f"{case} {fn}"] = dict(
                change_median_us=statistics.median(runs["change"]),
                parent_median_us=statistics.median(par),
                parent_quartile_spread_us=par[-1 - q] - par[q],
                change_faster=sum(c < p for c, p in zip(runs["change"],
                                                        runs["parent"])),
                pairs=args.pairs, runs=runs)
            r = res[f"{case} {fn}"]
            print(f"{case} {fn}: change {r['change_median_us']:.3f} us, "
                  f"parent {r['parent_median_us']:.3f} us (quartile "
                  f"spread {r['parent_quartile_spread_us']:.3f}); change "
                  f"faster in {r['change_faster']} of {args.pairs} pairs",
                  flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"change": sides["change"], "parent": sides["parent"],
                      "card": card, "compared": res}))


def main():
    if not torch.cuda.is_available():
        sys.exit("ln_host_timing.py: no CUDA device")
    assert os.path.dirname(os.path.abspath(pf.__file__)).startswith(
        os.path.abspath(args.root)), pf.__file__
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    res = {}
    for n, d, dtype in CASES:
        gen = torch.Generator(device="cuda").manual_seed(n + d)
        x = (torch.randn(n, d, device="cuda", generator=gen) * 3
             + 0.5).to(dtype)
        s, b = (torch.randn(d, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        got = KL.layer_norm(x, s, b, 1e-5)
        want = KL.layer_norm_plain(x, s, b, 1e-5)
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        assert dtype == torch.bfloat16 or err <= 1e-5, err
        tag = f"{str(dtype)[6:]} [{n},{d}]"
        res[tag] = dict(max_abs_err=err)
        for name, fn in (("layer_norm", KL.layer_norm),
                         ("_launch", KL._launch)):
            rounds = []
            for _ in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    fn(x, s, b, 1e-5)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                rounds.append((t1 - t0) / args.calls * 1e6)
            best, median = min(rounds), sorted(rounds)[3]
            res[tag][name] = dict(host_us=rounds, best_us=best,
                                  median_us=median)
            print(f"{tag} {name}: host us a call best {best:.3f}, median "
                  f"{median:.3f}", flush=True)
    print(card)
    print(json.dumps({"root": os.path.abspath(args.root), "card": card,
                      "cases": res}))


if __name__ == "__main__":
    compare() if args.against else main()
