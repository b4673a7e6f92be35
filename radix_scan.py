"""Scan chip_smoke.py phase 12's candidate prompts on the card.

    python3 radix_scan.py [--candidates N] [--cap T]

Phase 12 fixes its bias on end_id's logit column (RADIX_EOS_BIAS) and
its session, n_best and beam rows up front; this script is how they
were chosen. It builds phase 12's weights with end_id's bias at -30
(so that greedy decoding never ends), decodes each of the first N
candidate prompts greedily through PagedBeamDecoder at beam 1 for at
most T steps, and reads at each step, from the probe program's softmax
row, the margin log p(top token) - log p(end_id); adding back the -30
gives the margin at bias 0. With bias b a decode ends at the first step
whose margin at bias 0 falls below b, and the tokens before it do not
depend on b. For each bias on a grid it prints the candidates whose
turn 1 would end on end_id after 16 to 150 tokens; for the three biases
with the most, and for RADIX_EOS_BIAS, it then runs those candidates as
3-turn chat sessions on PagedContinuousGenerationServer and prints each
session's history lengths (None: a turn without end_id, or no room for
the next extension). Each qualifying candidate is printed with how far its
margins stay above the bias before the crossing and how far below it
the crossing step falls: a row whose two gaps are small is one rounding
away from another history. The weights' scales and the candidates come
from chip_smoke.py's RADIX_* constants.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as C  # noqa: E402
from paddle_tpu_torch.inference import serving  # noqa: E402

NEVER = -30.0  # end_id's bias while the margins are read


class _Stop(Exception):
    pass


def margins(paged, gpu, gscope, src, cap):
    """Per-step (margin at bias NEVER, top token) of `src`'s greedy
    decode, at most `cap` steps."""
    end = C.MODEL["end_id"]
    dec = serving.PagedBeamDecoder(paged, 1, executor=gpu, scope=gscope)
    run0, rec = dec._probe.run, []

    def run(feed, return_numpy=True):
        outs = run0(feed, return_numpy=return_numpy)
        p = np.asarray(outs[0])[0].astype(np.float64)
        pe = p[end]
        p[end] = -1.0
        rec.append((float(np.log(p.max()) - np.log(max(pe, 1e-300))),
                    int(p.argmax())))
        if len(rec) >= cap:
            raise _Stop()
        return outs

    dec._probe.run = run
    try:
        dec.decode(src)
    except _Stop:
        pass
    return rec


def sessions(paged, gpu, gscope, rows, cands, exts):
    """Each row's history length after each of phase 12's turns."""
    srv = C._radix_server(paged, gpu, gscope, True)
    hists = {r: [] for r in rows}
    try:
        for t in range(C.RADIX_TURNS):
            replies = {}
            for r in rows:
                if t and (not hists[r] or hists[r][-1] is None):
                    continue
                try:
                    replies[r] = srv.submit(
                        cands[r], session_id=f"s{r}",
                        extend_tokens=None if t == 0 else exts[r, t - 1])
                except ValueError:  # no room for the extension
                    hists[r].append(None)
            for r, rep in replies.items():
                out = rep.result(timeout=600)
                h = srv.session_history(f"s{r}")
                hists[r].append(len(h))
                if t == 0 and out[len(h)] != C.MODEL["end_id"]:
                    hists[r].append(None)
    finally:
        srv.close()
    return hists


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--candidates", type=int, default=C.RADIX_CANDIDATES)
    ap.add_argument("--cap", type=int, default=160)
    args = ap.parse_args()
    chosen = C.RADIX_EOS_BIAS
    name, _, card = C.phase_device()
    t0 = time.monotonic()
    gpu = C.pf.Executor(C.pf.CUDAPlace(0))
    C.RADIX_EOS_BIAS = NEVER
    paged, gscope, _, cands, exts = C._radix_setup(gpu)
    at0 = []
    for i in range(args.candidates):
        rec = margins(paged, gpu, gscope, cands[i], args.cap)
        m = np.array([x for x, _ in rec]) + NEVER
        at0.append(m)
        q = np.round(np.quantile(m[16:], [0, .1, .5, .9]), 4)
        print(f"candidate {i}: tokens {[t for _, t in rec][:12]}, "
              f"{len({t for _, t in rec})} distinct; margin at bias 0: "
              f"min of the first 16 steps {m[:16].min():.4f}, quantiles "
              f"0/0.1/0.5/0.9 after {q}", flush=True)
    grid = []
    for b in np.round(np.arange(-3.0, 6.001, 0.05), 2):
        ok = []
        for i, m in enumerate(at0):
            hits = np.nonzero(m < b)[0]
            t = int(hits[0]) if len(hits) else -1
            if C.RADIX_MIN_TURN1 <= t <= 150:
                ok.append((i, t, round(float(m[:t].min() - b), 4),
                           round(float(b - m[t]), 4)))
        if ok:
            print(f"bias {b}: {len(ok)} candidates (row, tokens before "
                  f"end_id, gap before, depth) {ok}", flush=True)
        grid.append((float(b), ok))
    top = sorted(grid, key=lambda g: -len(g[1]))[:3]
    if chosen not in [b for b, _ in top]:
        top += [g for g in grid if g[0] == chosen]
    for b, ok in top:
        C.RADIX_EOS_BIAS = b
        paged, gscope, _, cands, exts = C._radix_setup(gpu)
        rows = [i for i, *_ in ok][:C.PAGED["n_slots"]]
        for r, h in sessions(paged, gpu, gscope, rows, cands,
                             exts).items():
            print(f"bias {b}: row {r} history lengths {h}", flush=True)
    print(f"radix_scan: {time.monotonic() - t0:.1f} s on {name} ({card})")


if __name__ == "__main__":
    main()
