"""The bf16 kernels on wgmma: the fused blocks' #10 and #11
(``attention_block_fwd_bf16``, ``attention_block_bwd_bf16``) and #12 and
#13 (``ffn_block_fwd_bf16``, ``ffn_block_bwd_bf16``), the attention
kernels #2 (``flash_attention_fwd_bf16``), #3 + #4
(``flash_attention_bwd_dq_bf16``, ``flash_attention_bwd_dkv_bf16``), #5
(``sdpa_short_fwd_bf16``) and #6 (``sdpa_short_bwd_bf16``), the xent
forward #7 (``xent_fwd``), and the training legs around them, from one
checkout, on one card.

    python3 ffn_bf16_timing.py [--root DIR] [--kernels-only] [--legs L,...]
                               [--parts kernels,attention,xent,bits]

Imports DIR's ``chip_smoke.py`` and ``paddle_tpu_torch`` (default: this
checkout), so that two checkouts compare in one call on one card: run
parent, change, change, parent, each in its own process. It times #10
(without P and with it), #11, #12 and #13 at x [64, 256, 512] and at the
bench's [128, 256, 512] (H 8, F 2048), as chip_smoke.py times a kernel
(CUDA events behind a sleep kernel), the best of 3 rounds of 10
launches, and the host's time to enqueue one call of each, which is
what an eager step pays on the host for it. It profiles one launch each
of #10 (without P and with it) and #11 under torch.profiler and lists
their device activities in launch order with their device times: the
stages of the kernels. It does the same for #2 at [16, 8, 1024, 64]
(without lse, with it), #5 at [32, 8, 512, 64] (without P, with it), #6
at [32, 8, 512, 64], #3, #4 and #3 + #4 at [16, 8, 1024, 64], each also
causal: the shapes of the bf16 training legs at seq 1024 and 512; and
#7 at the MNIST head's [4096, 10] fp32 and the training shape [16384,
32000] in bf16 and fp32. It hashes the outputs of every kernel built on
the shared headers
(``flash_fwd.cuh``: #2, #5, #10; ``attn_bwd_from_p.cuh``: #6, #11;
``split_bf16.cuh``: #2-#6 in bf16; ``hopper.cuh`` and
``wgmma_bf16.cuh``: #10-#13 in bf16; ``attn_wgmma.cuh``: #2, #4, #5 and
#6 in bf16; ``tile_mma.cuh``: #10-#13 in fp32) and of the xent pair (#7
and #8, at the MNIST head, the training shape and the forward's
crossovers) on seeded inputs (#3 and #4 on the plain forward's out and
lse, and on #2's; #6 on #5's P and on the plain forward's), so that two
checkouts show which kernels kept their bits. Then, unless ``--kernels-only``, it runs DIR's
chip_smoke.py training legs, each with its own gates (``--legs`` picks
some, by the names below): phase 5's fp32 leg (seq 256, batch 64), the
bf16 leg at the bench's settings (seq 256, batch 128), phase 8's fp32
fused leg (seq 256, batch 64), the bf16 fused leg (seq 256, batch 128,
#10-#13 in bf16), the fp32 legs at seq 512 / batch 32 and 1024 / batch
16 and the bf16 legs at the same (#5 and #6, #2-#4 in bf16).

Prints, as its last line, one JSON object: the root, the card and its
power limit, the kernels' ms and host us, the stages, the output
hashes, and per leg the captured (run_steps) and eager step ms, busy
ms, idle share and eager peak memory.
"""
import argparse
import hashlib
import importlib
import json
import os
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
ap.add_argument("--kernels-only", action="store_true")
ap.add_argument("--legs", default=None,
                help="comma-separated leg names (default: all)")
ap.add_argument("--parts", default="kernels,attention,xent,bits",
                help="comma-separated parts of the kernel timing to run "
                     "(kernels, attention, xent, bits; default: all)")
args = ap.parse_args()
ROOT = os.path.abspath(args.root)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

BF = torch.bfloat16
T, D, H, F = 256, 512, 8, 2048
SCALE = (D // H) ** -0.5


def best_ms(cs, fn):
    return min(cs.time_ms(fn, iters=10) for _ in range(3))


def host_us(fn, n=20):
    """The host's time to enqueue one call of `fn`, in us: the mean over
    `n` calls issued back to back after a warm call, the card left to run
    behind them (the launches of 20 calls stay well inside the launch
    queue), the best of 3 rounds."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


def stages(run):
    """The device activities of `run()` under torch.profiler, in launch
    order: [(name, ms)]."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    acts = sorted((e for e in prof.events()
                   if e.device_type.name == "CUDA"),
                  key=lambda e: e.time_range.start)
    return [(e.name.split("(")[0][:120], e.time_range.elapsed_us() / 1e3)
            for e in acts]


def kernels(cs):
    """#10-#13 in bf16 at batch 64 and 128 (seq 256, D 512, H 8, F 2048),
    and the stages of one launch each of #10 and #11."""
    kab, kff = cs.KAB, cs.KFF
    res = {}
    for b in (64, 128):
        a = {k: v.to(BF) for k, v in cs._fused_inputs(
            b, T, D, F, seed=120 + b).items()}
        x, g, wqkv, wo, w1, b1, w2, b2 = (a[k] for k in (
            "x", "g", "wqkv", "wo", "w1", "b1", "w2", "b2"))
        _, p = kab._attention_block_launch(x, wqkv, wo, H, SCALE, False,
                                           True)
        runs = {
            "attention_block": lambda: kab._attention_block_launch(
                x, wqkv, wo, H, SCALE, False, False),
            "attention_block_with_p": lambda: kab._attention_block_launch(
                x, wqkv, wo, H, SCALE, False, True),
            "attention_block_bwd": lambda: kab.attention_block_bwd(
                x, wqkv, wo, p, g, H, SCALE),
            "ffn_block": lambda: kff._ffn_block_launch(x, w1, b1, w2, b2),
            "ffn_block_bwd": lambda: kff.ffn_block_bwd(x, w1, b1, w2, g),
        }
        out = {f"{n}_ms": best_ms(cs, fn) for n, fn in runs.items()}
        out |= {f"{n}_host_us": host_us(fn) for n, fn in runs.items()}
        # the function's products, each once, and as the kernels run them
        # (chip_smoke.py `_fused_bf16_flops`'s counts)
        n_p, gemm = b * H * T * T, 2 * b * T * D
        att = 2 * n_p * (D // H)
        prods = {"attention_block": (4 * gemm * D + 2 * att,
                                     5 * gemm * D + 6 * att),
                 "attention_block_bwd": (11 * gemm * D + 5 * att,
                                         18 * gemm * D + 18 * att),
                 "ffn_block": (2 * gemm * F, 3 * gemm * F),
                 "ffn_block_bwd": (5 * gemm * F, 8 * gemm * F)}
        for n, (flops, as_run) in prods.items():
            out[f"{n}_tflops"] = flops / out[f"{n}_ms"] / 1e9
            out[f"{n}_tflops_as_run"] = as_run / out[f"{n}_ms"] / 1e9
        out["stages"] = {n: stages(runs[n]) for n in (
            "attention_block", "attention_block_with_p",
            "attention_block_bwd")}
        res[b] = out
        cs.log(f"ffn_bf16_timing [{b},{T},{D}] H {H} F {F}: " + ", ".join(
            f"{n} {out[n + '_ms']:.4f} ms (host {out[n + '_host_us']:.1f} "
            f"us a call)" for n in runs))
        for n, st in out["stages"].items():
            cs.log(f"  stages of {n}: " + "; ".join(
                f"{name} {ms:.4f}" for name, ms in st))
        del a, x, g, p, runs
    return res


def attention(cs):
    """bf16 #2 at [16, 8, 1024, 64], #5 and #6 at [32, 8, 512, 64], #4 and
    #3 + #4 at [16, 8, 1024, 64] (the bf16 training legs' shapes),
    non-causal and causal: the whole launch, the host's enqueue time a
    call, the function's TFLOP/s and the stages of one launch."""
    ka = cs.KA
    res = {}

    def run(tag, fn, shape, flops):
        ms = best_ms(cs, fn)
        res[tag] = e = dict(ms=ms, host_us=host_us(fn), stages=stages(fn),
                            tflops=None if flops is None else
                            flops / ms / 1e9, shape=shape)
        cs.log(f"ffn_bf16_timing {tag} bf16 {shape}: {ms:.4f} ms (host "
               f"{e['host_us']:.1f} us a call)"
               + (f", {e['tflops']:.1f} TFLOP/s" if e["tflops"] else "")
               + "; stages: " + "; ".join(f"{n} {x:.4f}"
                                          for n, x in e["stages"]))

    for name, (b, t) in (("flash_attention", (16, 1024)),
                         ("sdpa_short", (32, 512))):
        q, k, v = (z.to(BF) for z in cs._qkv(b, 8, t, t, 64, seed=140 + t))
        g = cs._randn_like(q, 141 + t).to(BF)
        unit = 2 * b * 8 * t * t * 64  # one [t, t] x [t, 64] product
        shape = [b, 8, t, 64]
        for causal in (False, True):
            c = "_causal" if causal else ""
            # the function's products, non-causal only
            fl = (lambda n: None if causal else n * unit)
            if name == "flash_attention":
                run(name + c, lambda: ka._flash_attention_launch(
                    q, k, v, 0.125, causal, False), shape, fl(2))
                run(name + c + "_with_lse", lambda: ka._flash_attention_launch(
                    q, k, v, 0.125, causal, True), shape, fl(2))
                o, lse = ka._flash_attention_launch(q, k, v, 0.125, causal,
                                                    True)
                delta = ka.flash_delta(o, g)
                run("flash_bwd_dq" + c, lambda: ka.flash_bwd_dq(
                    q, k, v, g, lse, delta, 0.125, causal), shape, fl(3))
                run("flash_bwd_dkv" + c, lambda: ka.flash_bwd_dkv(
                    q, k, v, g, lse, delta, 0.125, causal), shape, fl(4))
                run("flash_bwd_dq_dkv" + c, lambda: (
                    ka.flash_bwd_dq(q, k, v, g, lse, delta, 0.125, causal),
                    ka.flash_bwd_dkv(q, k, v, g, lse, delta, 0.125,
                                     causal)), shape, fl(7))
            else:
                run(name + c, lambda: ka._sdpa_short_launch(
                    q, k, v, 0.125, causal, False), shape, fl(2))
                run(name + c + "_with_p", lambda: ka._sdpa_short_launch(
                    q, k, v, 0.125, causal, True), shape, fl(2))
                _, p = ka._sdpa_short_launch(q, k, v, 0.125, causal, True)
                run("sdpa_short_bwd" + c, lambda: ka.sdpa_short_bwd(
                    q, k, v, p, g, 0.125, causal), shape, fl(4))
        del q, k, v, g
    return res


def xent(cs):
    """#7 (the xent forward) at the MNIST head's [4096, 10] fp32 (eps 0)
    and at the training shape [16384, 32000] in bf16 and fp32 (eps 0.1),
    as chip_smoke.py times it: the whole launch, the host's enqueue time
    a call and the stages of one launch."""
    kx = cs.KX
    res = {}
    for n, v, dt, eps in ((4096, 10, torch.float32, 0.0),
                          (16384, 32000, BF, 0.1),
                          (16384, 32000, torch.float32, 0.1)):
        x, lab, _ = cs._xent_case(n, v, dt, 30, ignored=False)
        fn = (lambda: kx.xent_forward(x, lab, eps))
        tag = f"xent_forward [{n},{v}] {str(dt)[6:]}"
        res[tag] = e = dict(ms=best_ms(cs, fn), host_us=host_us(fn),
                            stages=stages(fn))
        cs.log(f"ffn_bf16_timing {tag}: {e['ms']:.4f} ms (host "
               f"{e['host_us']:.1f} us a call); stages: " + "; ".join(
                   f"{a} {t:.4f}" for a, t in e["stages"]))
        del x, lab
    return res


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def bits(cs):
    """sha256 of the outputs of the kernels built on the shared headers,
    on seeded inputs: equal across two checkouts where a kernel kept its
    bits."""
    ka, kab, kff = cs.KA, cs.KAB, cs.KFF
    out = {}
    for dt, tag in ((torch.float32, "fp32"), (BF, "bf16")):
        a = {k: v.to(dt) for k, v in cs._fused_inputs(
            8, T, D, F, seed=130).items()}
        x, g, wqkv, wo, w1, b1, w2, b2 = (a[k] for k in (
            "x", "g", "wqkv", "wo", "w1", "b1", "w2", "b2"))
        for causal in (False, True):
            o, p = kab._attention_block_launch(x, wqkv, wo, H, SCALE, causal,
                                               True)
            out[f"#10 {tag} causal={causal}"] = digest(
                o, p, kab._attention_block_launch(x, wqkv, wo, H, SCALE,
                                                  causal, False))
            out[f"#11 {tag} causal={causal}"] = digest(
                *kab.attention_block_bwd(x, wqkv, wo, p, g, H, SCALE,
                                         causal))
        out[f"#12 {tag}"] = digest(kff._ffn_block_launch(x, w1, b1, w2, b2))
        out[f"#13 {tag}"] = digest(*kff.ffn_block_bwd(x, w1, b1, w2, g))
        q, k, v = (z.to(dt) for z in cs._qkv(4, 8, 512, 512, 64, seed=131))
        go = cs._qkv(4, 8, 512, 512, 64, seed=132)[0].to(dt)
        for causal in (False, True):
            o, p = ka._sdpa_short_launch(q, k, v, 0.125, causal, True)
            out[f"#5 {tag} causal={causal}"] = digest(o, p)
            out[f"#6 {tag} causal={causal}"] = digest(
                *ka.sdpa_short_bwd(q, k, v, p, go, 0.125, causal))
            # #6 on the plain forward's P too, so that its hash does not
            # follow #5's
            _, p = ka.sdpa_short_plain(q, k, v, 0.125, causal, save_p=True)
            out[f"#6 {tag} causal={causal} on the plain P"] = digest(
                *ka.sdpa_short_bwd(q, k, v, p, go, 0.125, causal))
            out[f"#5 {tag} causal={causal} without P"] = digest(
                ka._sdpa_short_launch(q, k, v, 0.125, causal, False))
            o, lse = ka._flash_attention_launch(q, k, v, 0.125, causal, True)
            out[f"#2 {tag} causal={causal}"] = digest(o, lse)
            # #3 and #4 on #2's out and lse too
            delta = ka.flash_delta(o, go)
            out[f"#3 {tag} causal={causal} on #2"] = digest(ka.flash_bwd_dq(
                q, k, v, go, lse, delta, 0.125, causal))
            out[f"#4 {tag} causal={causal} on #2"] = digest(*ka.flash_bwd_dkv(
                q, k, v, go, lse, delta, 0.125, causal))
            # #3 and #4 from the plain forward's out and lse, so that their
            # hashes do not follow #2's
            o, lse = ka.flash_attention_plain(q, k, v, 0.125, causal,
                                              with_lse=True)
            delta = ka.flash_delta(o, go)
            out[f"#3 {tag} causal={causal}"] = digest(ka.flash_bwd_dq(
                q, k, v, go, lse, delta, 0.125, causal))
            out[f"#4 {tag} causal={causal}"] = digest(*ka.flash_bwd_dkv(
                q, k, v, go, lse, delta, 0.125, causal))
        # the xent pair at the MNIST head, the training shape and the
        # forward's crossovers (#7: loss and lse; #8: dx)
        for n, v, eps in ((4096, 10, 0.0), (2048, 32000, 0.1), (64, 1, 0.0),
                          (64, 32, 0.1), (64, 33, 0.1), (64, 4096, 0.1),
                          (64, 4097, 0.1), (64, 8193, 0.1), (64, 1003, 0.1)):
            x, lab, dl = cs._xent_case(n, v, dt, 150 + v)
            out[f"#7 {tag} [{n},{v}]"] = digest(*cs.KX.xent_forward(
                x, lab, eps))
            out[f"#8 {tag} [{n},{v}]"] = digest(cs.KX.xent_backward(
                x, lab, dl, eps))
        # the other head widths: #2 at d 128 and 256, #3 and #4 at d 128
        # and 256 (an odd tq at 128), #5 and #6 at d 128
        for d in (128, 256):
            q, k, v = (z.to(dt) for z in cs._qkv(2, 4, 300, 300, d,
                                                 seed=133 + d))
            go = cs._qkv(2, 4, 300, 300, d, seed=134 + d)[0].to(dt)
            out[f"#2 {tag} d{d}"] = digest(*ka._flash_attention_launch(
                q, k, v, d ** -0.5, True, True))
            tq = 301 if d == 128 else 300
            qo, gq = (cs._qkv(2, 4, tq, 300, d, seed=135 + d + i)[0].to(dt)
                      for i in range(2))
            o, lse = ka.flash_attention_plain(qo, k, v, d ** -0.5, True,
                                              with_lse=True)
            out[f"#4 {tag} d{d} tq {tq}"] = digest(*ka.flash_bwd_dkv(
                qo, k, v, gq, lse, ka.flash_delta(o, gq), d ** -0.5, True))
            out[f"#3 {tag} d{d} tq {tq}"] = digest(ka.flash_bwd_dq(
                qo, k, v, gq, lse, ka.flash_delta(o, gq), d ** -0.5, True))
            if d == 128:
                o, p = ka._sdpa_short_launch(q, k, v, d ** -0.5, True, True)
                out[f"#5 {tag} d{d}"] = digest(o, p)
                out[f"#6 {tag} d{d}"] = digest(*ka.sdpa_short_bwd(
                    q, k, v, p, go, d ** -0.5, True))
    return out


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
    parts = dict(kernels=kernels, attention=attention, xent=xent, bits=bits)
    out = dict(root=ROOT, card=card) | {
        n: parts[n](cs) for n in args.parts.split(",") if n}
    if not args.kernels_only:
        fp32 = {}

        def fp32_leg(t, b):
            fp32[t] = cs.phase_train(name, card, t, b)[1]
            return fp32[t]

        legs = {
            "fp32 256x64": lambda: fp32_leg(256, 64),
            "bf16 256x128": lambda: cs.phase_train_bf16(name, card, 256,
                                                        128)[1],
            "fp32 fused 256x64": lambda: cs.phase_train_fused(
                name, card, fp32[256] if 256 in fp32 else fp32_leg(256, 64)
            )[1],
            "bf16 fused 256x128": lambda: cs.phase_train_bf16(
                name, card, 256, 128, fused=True)[1],
            "fp32 512x32": lambda: fp32_leg(512, 32),
            "fp32 1024x16": lambda: fp32_leg(1024, 16),
            "bf16 512x32": lambda: cs.phase_train_bf16(name, card, 512,
                                                       32)[1],
            "bf16 1024x16": lambda: cs.phase_train_bf16(name, card, 1024,
                                                        16)[1],
        }
        pick = args.legs.split(",") if args.legs else list(legs)
        out["legs"] = {n: leg(legs[n]()) for n in pick}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
