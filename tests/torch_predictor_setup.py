"""Shared set-up of the export and predictor tests: the same small
Transformer and the MNIST fc net built in both packages under the same
names, the JAX package's seeded weights carried into the port by name,
and each package's ``save_inference_model`` writing a model directory.

The Transformer is 2+2 layers at d 64, 4 heads, vocab 97, built by each
package's ``build_program(with_optimizer=False, dropout_rate=0.1)``,
cloned for test and cut to its logits (the output of the ``logits.w``
mul). At seq 40 its attention ops take the plain composition, at seq 300
the ``sdpa_short`` route's plain version.
"""
from __future__ import annotations

import contextlib

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import native as j_native
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.inference import (AnalysisConfig as JConfig,
                                  PaddleTensor as JTensor,
                                  create_paddle_predictor as j_create)
from paddle_tpu.models import mnist as JM
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.inference import (AnalysisConfig as PConfig,
                                        PaddleTensor as PTensor,
                                        create_paddle_predictor as p_create)
from paddle_tpu_torch.models import mnist as PM
from paddle_tpu_torch.models import transformer as PT

SMALL = dict(d_model=64, n_heads=4, n_layers=2, d_inner=128, vocab=97,
             with_optimizer=False, dropout_rate=0.1)
FEEDS = ["src_ids", "tgt_ids"]
SEED = 7


def logits_name(program):
    """The output of the mul reading logits.w."""
    for op in program.global_block.ops:
        if op.type == "mul" and op.inputs["Y"] == ["logits.w"]:
            return op.outputs["Out"][0]
    raise KeyError("logits.w")


def _weights(startup):
    """The JAX package's startup run from SEED: {name: array}."""
    startup.random_seed = SEED
    scope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(startup, scope=scope)
    return {n: np.asarray(scope._get(n))
            for n, v in startup.global_block.vars.items() if v.persistable}


def transformer_pair(seq_len):
    """(JAX test program, port test program, fetch name, weights)."""
    with j_unique_name.guard():
        jmain, jstart, _ = JT.build_program(seq_len=seq_len, **SMALL)
    with p_unique_name.guard():
        pmain, _, _ = PT.build_program(seq_len=seq_len, **SMALL)
    jtest, ptest = jmain.clone(for_test=True), pmain.clone(for_test=True)
    name = logits_name(jtest)
    assert name == logits_name(ptest)
    return jtest, ptest, name, _weights(jstart)


def mnist_pair():
    """The MNIST fc net's test programs, fetching the logits (the last
    fc's bias add), and the JAX package's weights."""
    with j_unique_name.guard():
        jmain = jf.Program()
        jstart = jf.Program()
        with jf.program_guard(jmain, jstart):
            img = jf.layers.data("img", shape=[784], dtype="float32")
            label = jf.layers.data("label", shape=[1], dtype="int64")
            _, _, jlogits = JM.mlp(img, label)
    with p_unique_name.guard():
        pmain = pf.Program()
        pstart = pf.Program()
        with pf.program_guard(pmain, pstart):
            img = pf.layers.data("img", shape=[784], dtype="float32")
            label = pf.layers.data("label", shape=[1], dtype="int64")
            _, _, plogits = PM.mlp(img, label)
    assert jlogits.name == plogits.name
    return (jmain.clone(for_test=True), pmain.clone(for_test=True),
            jlogits.name, _weights(jstart))


@contextlib.contextmanager
def jax_json_only():
    """The JAX package's save path as on a host without its C++ core:
    ``__model__`` as JSON in place of PTPF."""
    avail = j_native.available
    j_native.available = lambda: False
    try:
        yield
    finally:
        j_native.available = avail


def jax_save(dirname, program, fetch, weights, feeds=FEEDS, **kw):
    """The JAX package's save_inference_model of `program` holding
    `weights` (PTPF + .meta where its C++ core builds)."""
    scope = jf.Scope()
    for n, a in weights.items():
        scope._set(n, a)
    with jf.scope_guard(scope):
        jf.save_inference_model(dirname, feeds,
                                [program.global_block.var(fetch)],
                                jf.Executor(jf.CPUPlace()),
                                main_program=program, **kw)


def port_save(dirname, program, fetch, weights, feeds=FEEDS, **kw):
    """The port's save_inference_model of `program` holding `weights`."""
    scope = pf.Scope()
    pf.load_numpy_params(scope, weights, pf.CPUPlace())
    with pf.scope_guard(scope):
        pf.save_inference_model(dirname, feeds,
                                [program.global_block.var(fetch)],
                                pf.Executor(pf.CPUPlace()),
                                main_program=program, **kw)


def token_feed(seq_len, rows=2, seed=0):
    rs = np.random.RandomState(seed)
    return {n: rs.randint(0, SMALL["vocab"], (rows, seq_len)).astype(
        "int64") for n in FEEDS}


def j_predictor(dirname, bf16=False, ir=True):
    cfg = JConfig(dirname)
    cfg.switch_ir_optim(ir)
    if bf16:
        cfg.enable_tpu_bf16()
    return j_create(cfg)


def p_predictor(dirname, bf16=False, ir=True):
    cfg = PConfig(dirname)
    cfg.disable_gpu()
    cfg.switch_ir_optim(ir)
    if bf16:
        cfg.enable_tpu_bf16()
    return p_create(cfg)


def j_run(pred, feed):
    return pred.run([JTensor(v, name=n) for n, v in feed.items()])[0].data


def p_run(pred, feed):
    return pred.run([PTensor(v, name=n) for n, v in feed.items()])[0].data
