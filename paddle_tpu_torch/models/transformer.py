"""Transformer base (the port's counterpart of
paddle_tpu/models/transformer.py; reference
tests/unittests/dist_transformer.py and the WMT en-de base config:
d_model=512, 8 heads, 6+6 layers, ffn 2048, Adam + noam decay).

The building blocks serve both the decode programs (is_test=True) and
the training program ``build_program``. Parameter names are the JAX
package's explicit ones, so weights carry over between the two packages
by name. A nonzero dropout rate outside is_test adds the JAX package's
dropout ops: after the embeddings, on each attention's P, on the FFN
hidden and before each add-norm, all ``upscale_in_train``.
``build_program(recompute=True)`` keeps each layer's output as a
checkpoint and recomputes the rest in the backward (RecomputeOptimizer).

PADDLE_TPU_FUSE_ATTN_BLOCK=1, read at build time as in the JAX package,
builds each self-attention sub-layer of a training program (not is_test,
dropout 0) as one ``attention_block`` op and each FFN as one
``ffn_block`` op, with the same parameters; decode builds and a nonzero
dropout rate stay unfused.
"""
from __future__ import annotations

import os

import numpy as np

from .. import layers, unique_name
from ..initializer import XavierInitializer
from ..param_attr import ParamAttr
# re-exports, as the JAX module makes them: the decode builders live in
# decode_engine
from .decode_engine import (CacheConfig, DecodeStepBundle,  # noqa: F401
                            build_beam_decode_program,
                            build_decode_step_program,
                            build_greedy_decode_program,
                            build_incremental_decode_program)


def _position_encoding(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype("float64")
    dim = np.arange(0, d_model, 2).astype("float64")
    angle = pos / np.power(10000.0, dim / d_model)
    enc = np.zeros((max_len, d_model), dtype="float32")
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc


def _attn_proj_attr(name, tag, d_model):
    """Attention projection param with explicit Xavier fans (the fused
    qkv shape would otherwise shrink the init scale)."""
    return ParamAttr(
        name=f"{name}_{tag}.w" if name else
        unique_name.generate(f"attn_{tag}_proj.w"),
        initializer=XavierInitializer(fan_in=d_model, fan_out=d_model))


def multi_head_attention(q_in, kv_in, d_model, n_heads, dropout_rate,
                         causal=False, is_test=False, name=None):
    head_dim = d_model // n_heads

    def _proj_attr(tag):
        return _attn_proj_attr(name, tag, d_model)

    if (q_in is kv_in and not is_test and dropout_rate == 0.0
            and os.environ.get("PADDLE_TPU_FUSE_ATTN_BLOCK") == "1"):
        # the whole sub-layer as one op: same parameters (names, Xavier
        # fans), same math
        return layers.attention_block(
            q_in, n_heads, causal=causal,
            param_attr_qkv=_proj_attr("qkv"),
            param_attr_out=f"{name}_out.w" if name else None, name=name)

    if q_in is kv_in:
        qkv = layers.fc(q_in, 3 * d_model, num_flatten_dims=2,
                        bias_attr=False, param_attr=_proj_attr("qkv"))
        q, k, v = layers.split(qkv, 3, dim=2)
    else:
        q = layers.fc(q_in, d_model, num_flatten_dims=2,
                      bias_attr=False, param_attr=_proj_attr("q"))
        kv = layers.fc(kv_in, 2 * d_model, num_flatten_dims=2,
                       bias_attr=False, param_attr=_proj_attr("kv"))
        k, v = layers.split(kv, 2, dim=2)

    def split_heads(x):
        return layers.reshape(x, [0, 0, n_heads, head_dim])

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    ctx = layers.attention(q, k, v, causal=causal,
                           scale=head_dim ** -0.5,
                           dropout_rate=0.0 if is_test else dropout_rate,
                           layout="bthd")
    ctx = layers.reshape(ctx, [0, 0, d_model])
    return layers.fc(ctx, d_model, num_flatten_dims=2, bias_attr=False,
                     param_attr=f"{name}_out.w" if name else None)


def _ffn(x, d_model, d_inner, dropout_rate, is_test, name=None):
    if (not is_test and dropout_rate == 0.0
            and os.environ.get("PADDLE_TPU_FUSE_ATTN_BLOCK") == "1"):
        return layers.ffn_block(
            x, d_inner,
            param_attr_fc1=f"{name}_fc1.w" if name else None,
            bias_attr_fc1=f"{name}_fc1.b" if name else None,
            param_attr_fc2=f"{name}_fc2.w" if name else None,
            bias_attr_fc2=f"{name}_fc2.b" if name else None, name=name)
    h = layers.fc(x, d_inner, num_flatten_dims=2, act="relu",
                  param_attr=f"{name}_fc1.w" if name else None,
                  bias_attr=f"{name}_fc1.b" if name else None)
    if dropout_rate and not is_test:
        h = layers.dropout(h, dropout_rate,
                           dropout_implementation="upscale_in_train")
    return layers.fc(h, d_model, num_flatten_dims=2,
                     param_attr=f"{name}_fc2.w" if name else None,
                     bias_attr=f"{name}_fc2.b" if name else None)


def _add_norm(x, residual, dropout_rate, is_test, name=None):
    if dropout_rate and not is_test:
        x = layers.dropout(x, dropout_rate,
                           dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, residual),
                             begin_norm_axis=2,
                             param_attr=f"{name}_ln.w" if name else None,
                             bias_attr=f"{name}_ln.b" if name else None)


def encoder_layer(x, d_model, n_heads, d_inner, dropout_rate, is_test,
                  name=None):
    attn = multi_head_attention(x, x, d_model, n_heads, dropout_rate,
                                is_test=is_test,
                                name=f"{name}_self" if name else None)
    x = _add_norm(attn, x, dropout_rate, is_test,
                  name=f"{name}_a" if name else None)
    ffn = _ffn(x, d_model, d_inner, dropout_rate, is_test,
               name=f"{name}" if name else None)
    return _add_norm(ffn, x, dropout_rate, is_test,
                     name=f"{name}_b" if name else None)


def decoder_layer(x, enc_out, d_model, n_heads, d_inner, dropout_rate,
                  is_test, name=None):
    self_attn = multi_head_attention(x, x, d_model, n_heads, dropout_rate,
                                     causal=True, is_test=is_test,
                                     name=f"{name}_self" if name else None)
    x = _add_norm(self_attn, x, dropout_rate, is_test,
                  name=f"{name}_a" if name else None)
    cross = multi_head_attention(x, enc_out, d_model, n_heads, dropout_rate,
                                 is_test=is_test,
                                 name=f"{name}_cross" if name else None)
    x = _add_norm(cross, x, dropout_rate, is_test,
                  name=f"{name}_b" if name else None)
    ffn = _ffn(x, d_model, d_inner, dropout_rate, is_test,
               name=f"{name}" if name else None)
    return _add_norm(ffn, x, dropout_rate, is_test,
                     name=f"{name}_c" if name else None)


def _embed(ids, vocab_size, d_model, max_len, dropout_rate, is_test,
           emb_name):
    emb = layers.embedding(ids, size=[vocab_size, d_model],
                           param_attr=ParamAttr(name=emb_name))
    emb = layers.scale(emb, scale=d_model ** 0.5)
    pos_table = _position_encoding(max_len, d_model)
    seq_len = emb.shape[1] if emb.shape[1] and emb.shape[1] > 0 \
        else max_len
    pos = layers.assign(pos_table[:seq_len])
    emb = layers.elementwise_add(emb, pos, axis=1)
    if dropout_rate and not is_test:
        emb = layers.dropout(emb, dropout_rate,
                             dropout_implementation="upscale_in_train")
    return emb


def transformer(src_ids, tgt_ids, label, src_vocab=30000, tgt_vocab=30000,
                max_len=256, d_model=512, n_heads=8, n_layers=6,
                d_inner=2048, dropout_rate=0.1, is_test=False,
                label_smooth_eps=0.1, checkpoints=None, name_prefix=""):
    """Returns (avg_cost, logits). src_ids/tgt_ids: [B,T] int64; label:
    [B,T] int64 next-token targets. When `checkpoints` is a list, each
    layer's output is appended to it (for RecomputeOptimizer).
    ``name_prefix`` prefixes every parameter name."""
    p = name_prefix
    enc = _embed(src_ids, src_vocab, d_model, max_len, dropout_rate,
                 is_test, f"{p}src_word_emb")
    for li in range(n_layers):
        enc = encoder_layer(enc, d_model, n_heads, d_inner, dropout_rate,
                            is_test, name=f"{p}enc{li}")
        if checkpoints is not None:
            checkpoints.append(enc)
    dec = _embed(tgt_ids, tgt_vocab, d_model, max_len, dropout_rate,
                 is_test, f"{p}tgt_word_emb")
    for li in range(n_layers):
        dec = decoder_layer(dec, enc, d_model, n_heads, d_inner,
                            dropout_rate, is_test, name=f"{p}dec{li}")
        if checkpoints is not None:
            checkpoints.append(dec)
    logits = layers.fc(dec, tgt_vocab, num_flatten_dims=2, bias_attr=False,
                       param_attr=f"{p}logits.w")
    # smoothing fused into the loss: never an [B,T,V] one-hot
    cost = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(label, [2]),
        label_smooth_eps=label_smooth_eps)
    return layers.mean(cost), logits


def build_program(batch_size=None, seq_len=64, d_model=512, n_heads=8,
                  n_layers=6, d_inner=2048, vocab=30000, learning_rate=2.0,
                  warmup_steps=4000, with_optimizer=True, dropout_rate=0.1,
                  recompute=False, name_prefix=""):
    """(main, startup, avg_cost): the training program, fed src_ids,
    tgt_ids and label ([B, seq_len] int64), with Adam (beta1 0.9, beta2
    0.997, eps 1e-9) under noam_decay(d_model, warmup_steps); with
    `recompute`, inside a RecomputeOptimizer that keeps every layer's
    output and recomputes the rest. As in the JAX package, noam_decay sets
    the rate and `learning_rate` is not read."""
    import paddle_tpu_torch as fluid

    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        src = layers.data("src_ids", shape=[seq_len], dtype="int64")
        tgt = layers.data("tgt_ids", shape=[seq_len], dtype="int64")
        label = layers.data("label", shape=[seq_len], dtype="int64")
        ck = [] if recompute else None
        avg_cost, _ = transformer(
            src, tgt, label, src_vocab=vocab, tgt_vocab=vocab,
            max_len=max(seq_len, 256), d_model=d_model, n_heads=n_heads,
            n_layers=n_layers, d_inner=d_inner, dropout_rate=dropout_rate,
            checkpoints=ck, name_prefix=name_prefix)
        if with_optimizer:
            lr = layers.learning_rate_scheduler.noam_decay(d_model,
                                                           warmup_steps)
            opt = fluid.optimizer.Adam(learning_rate=lr, beta1=0.9,
                                       beta2=0.997, epsilon=1e-9)
            if recompute:
                opt = fluid.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints(ck)
            opt.minimize(avg_cost)
    return main, startup, avg_cost
