"""The Transformer under bf16 AMP in both packages, for
``test_torch_amp.py`` (seq 264: sdpa_short) and
``test_torch_amp_flash.py`` (seq 576: flash): the same weights, feeds and
3 Adam steps, the JAX package's side in a process of its own.

    python tests/torch_amp_setup.py SEQ_LEN OUT.npz

runs that side alone (with REF_XLA_FLAGS in XLA_FLAGS) and writes its
initial weights, losses and @GRAD dtypes to OUT.npz.
"""
import os
import subprocess
import sys

import jax
import numpy as np

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import amp as jamp
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.models import transformer as PT

AMP_CFG = dict(d_model=128, n_heads=2, n_layers=2, d_inner=256, vocab=256,
               dropout_rate=0.0)
AMP_BATCH = 4   # B * H = 8: the Pallas sdpa_short groups 8 heads
AMP_STEPS = 3
AMP_LOSS_RTOL = 1e-4
# XLA may skip the rounding of a bf16 value that it fuses into an fp32
# consumer (its default `xla_allow_excess_precision`): the JAX package's
# CPU run then rounds at other places than its ops say, and than the
# port does (bf16 layer_norm inputs, for one, reach the statistics
# unrounded). The reference run below turns that off, so every op's bf16
# output is rounded as the op states, as it is on the card.
REF_XLA_FLAGS = "--xla_allow_excess_precision=false"


def _persistables(startup):
    return [n for n, v in startup.global_block.vars.items() if v.persistable]


def _amp_programs(pkg, T, seq_len):
    return T.build_program(warmup_steps=100, seq_len=seq_len, **AMP_CFG)


def _amp_feed(seq_len):
    rs = np.random.RandomState(11)
    return {k: rs.randint(0, AMP_CFG["vocab"], (AMP_BATCH, seq_len)).astype(
        "int64") for k in ("src_ids", "tgt_ids", "label")}


def _grad_names(main):
    return sorted({n for op in main.global_block.ops
                   for n in op.output_arg_names if n.endswith("@GRAD")})


def _reference_run(seq_len, out):
    """The JAX package's side, in a process of its own (REF_XLA_FLAGS):
    its initial weights, and for AMP on and off 3 Adam steps' losses
    from those weights and the step-1 dtype of every @GRAD, its Pallas
    kernels in interpret mode (as its own tests run them on the CPU), so
    both packages run the kernels' functions at the routed lengths."""
    from paddle_tpu.ops.pallas import attention as jattn

    with j_unique_name.guard():
        main, start, cost = _amp_programs(jf, JT, seq_len)
    exe = jf.Executor(jf.CPUPlace())
    scope = jf.Scope()
    exe.run(start, scope=scope)
    names = _persistables(start)
    state = {n: np.asarray(scope.find_var(n).get_tensor()) for n in names}
    feed, grads = _amp_feed(seq_len), _grad_names(main)
    res = {"state." + n: v for n, v in state.items()}
    for use_amp in (True, False):
        # the fp32 run needs no interpret mode: the kernels' fp32
        # functions equal the composition's within 1e-5
        jattn.force_interpret(use_amp)
        sc = jf.Scope()
        exe.run(start, scope=sc)
        for n, v in state.items():
            sc.find_var(n).get_tensor().set(v, jf.CPUPlace())
        losses = []
        with jamp.amp_guard(use_amp):
            for step in range(AMP_STEPS):
                # one fetch list for every step: one compile
                r = exe.run(main, feed=feed, scope=sc, return_numpy=False,
                            fetch_list=[cost.name] + grads)
                losses.append(float(np.asarray(r[0]).reshape(())))
                if step == 0 and use_amp:
                    res["dtypes"] = np.array([str(x.dtype) for x in r[1:]])
        res[f"losses.{use_amp}"] = np.array(losses)
    jattn.force_interpret(False)
    np.savez(out, **res)


def train(seq_len, tmp_path):
    """(JAX losses, port losses) for AMP on and off, and {@GRAD name:
    (JAX dtype, port dtype)} under AMP."""
    out = tmp_path / f"ref_{seq_len}.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, XLA_FLAGS=REF_XLA_FLAGS, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    subprocess.run([sys.executable, __file__, str(seq_len), str(out)],
                   env=env, check=True, timeout=600)
    ref = np.load(out)
    state = {k[6:]: ref[k] for k in ref.files if k.startswith("state.")}
    with p_unique_name.guard():
        main, start, cost = _amp_programs(pf, PT, seq_len)
    exe = pf.Executor(pf.CPUPlace())
    feed, grads = _amp_feed(seq_len), _grad_names(main)
    losses, dtypes = {}, {}
    for use_amp in (True, False):
        scope = pf.Scope()
        pf.load_numpy_params(scope, state, pf.CPUPlace())
        got = []
        with pamp.amp_guard(use_amp):
            for step in range(AMP_STEPS):
                r = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                            fetch_list=[cost.name] + grads)
                got.append(float(r[0].reshape(())))
                if step == 0 and use_amp:
                    dtypes = {n: (j, str(x.dtype).replace("torch.", ""))
                              for n, j, x in zip(grads, ref["dtypes"],
                                                 r[1:])}
        losses[use_amp] = (ref[f"losses.{use_amp}"], np.array(got))
    return losses, dtypes




def check_amp_training(seq_len, tmp_path):
    """Under AMP the port's losses follow the JAX package's bf16 run
    within AMP_LOSS_RTOL, and more closely than either package's fp32
    run; every @GRAD has the JAX package's dtype, some bf16 (the white
    ops' grads) and some fp32."""
    losses, dtypes = train(seq_len, tmp_path)
    (jb, pb), (jfp, pfp) = losses[True], losses[False]
    assert np.isfinite(pb).all()
    gap = np.abs(pb - jb) / np.abs(jb)
    own = min(np.abs(jb - jfp).max() / np.abs(jfp).max(),
              np.abs(pb - pfp).max() / np.abs(pfp).max())
    assert gap.max() <= AMP_LOSS_RTOL, (pb, jb)
    assert gap.max() < own, (gap, own)
    mism = {n: d for n, d in dtypes.items() if d[0] != d[1]}
    assert not mism, mism
    assert any(d[1] == "bfloat16" for d in dtypes.values())
    assert any(d[1] == "float32" for d in dtypes.values())


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _reference_run(int(sys.argv[1]), sys.argv[2])
