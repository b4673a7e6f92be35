"""NN layers (reference python/paddle/fluid/layers/nn.py; the port's
subset of paddle_tpu/layers/nn.py). Each function appends ops
to the default main program through LayerHelper."""
from __future__ import annotations

import numpy as np

from ..core.types import as_datatype
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "layer_norm", "attention", "softmax", "relu",
    "matmul", "reshape", "transpose", "split", "unsqueeze", "scale",
    "cast", "argmax", "reduce_sum", "increment", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "elementwise_max",
    "elementwise_min", "softmax_with_cross_entropy", "mean",
    "attention_block", "ffn_block", "gather", "expand",
    "masked_pool_write", "paged_decode_attention", "dropout", "clip",
    "clip_by_norm", "elementwise_div", "elementwise_pow", "topk",
    "concat", "filtered_softmax", "sample_categorical", "one_hot",
    "reduce_max", "span_scatter", "spec_accept", "conv2d", "pool2d",
    "scatter", "gaussian_random", "elementwise_mod",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected (reference layers/nn.py fc): out = act(X W + b)."""
    if isinstance(input, (list, tuple)):
        raise NotImplementedError("fc over several inputs is not ported "
                                  "yet")
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    in_features = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(helper.param_attr, [in_features, size],
                                input.dtype)
    tmp = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("mul", {"X": input, "Y": w}, {"Out": tmp},
                     {"x_num_col_dims": num_flatten_dims,
                      "y_num_col_dims": 1})
    pre_act = helper.append_bias_op(tmp, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32",
              name=None):
    """reference layers/nn.py embedding -> lookup_table op."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(helper.param_attr, size, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lookup_table", {"Ids": input, "W": w}, {"Out": out},
        {"is_sparse": is_sparse, "is_distributed": is_distributed,
         "padding_idx": -1 if padding_idx is None else padding_idx})
    return out


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None):
    """NCHW convolution (reference layers/nn.py conv2d): an OIHW filter
    initialized He-normal (std sqrt(2 / (kh kw C))) unless `param_attr`
    says otherwise, a per-channel bias, then `act`."""
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    fs = _pair(filter_size)
    std = (2.0 / (fs[0] * fs[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr, [num_filters, num_channels // groups, fs[0],
                            fs[1]], input.dtype,
        default_initializer=NormalInitializer(0.0, std))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv2d", {"Input": input, "Filter": w}, {"Output": out},
        {"strides": _pair(stride), "paddings": _pair(padding),
         "dilations": _pair(dilation), "groups": groups})
    b = helper.create_parameter(helper.bias_attr, [out.shape[1]],
                                out.dtype, is_bias=True)
    if b is not None:
        biased = helper.create_variable_for_type_inference(out.dtype)
        helper.append_op("elementwise_add", {"X": out, "Y": b},
                         {"Out": biased}, {"axis": 1})
        out = biased
    return helper.append_activation(out)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    """Max or average pooling over NCHW windows (reference layers/nn.py
    pool2d)."""
    helper = LayerHelper("pool2d", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", {"X": input}, {"Out": out},
        {"pooling_type": pool_type, "ksize": _pair(pool_size),
         "strides": _pair(pool_stride), "paddings": _pair(pool_padding),
         "global_pooling": global_pooling, "ceil_mode": ceil_mode,
         "exclusive": exclusive})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    dim = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            helper.param_attr, [dim], dtype,
            default_initializer=ConstantInitializer(1.0))
    if shift:
        b = helper.create_parameter(helper.bias_attr, [dim], dtype,
                                    is_bias=True)
        if b is not None:
            inputs["Bias"] = b
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype, True)
    var = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("layer_norm", inputs,
                     {"Y": out, "Mean": mean, "Variance": var},
                     {"epsilon": epsilon,
                      "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def attention(q, k, v, causal=False, scale=None, dropout_rate=0.0,
              is_test=False, layout="bhtd", name=None):
    """Fused scaled-dot-product attention: the entry point of the
    sdpa_short and flash-attention kernels (ops/nn_ops.py attention)."""
    helper = LayerHelper("attention", input=q, name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op("attention", {"Q": q, "K": k, "V": v},
                     {"Out": out},
                     {"causal": causal, "scale": scale,
                      "dropout_rate": dropout_rate,
                      "is_test": is_test, "layout": layout})
    return out


def attention_block(x, n_heads, causal=False, scale=None,
                    param_attr_qkv=None, param_attr_out=None, name=None):
    """The whole self-attention sub-layer as one op (no dropout, no
    projection biases, the residual outside), in place of the
    qkv-fc/split/reshape/attention/reshape/out-fc sequence: the entry point
    of the attention_block kernels. models/transformer routes
    multi_head_attention here under PADDLE_TPU_FUSE_ATTN_BLOCK=1."""
    helper = LayerHelper("attention_block", input=x,
                         param_attr=param_attr_qkv, name=name)
    d = int(x.shape[-1])
    if d % n_heads:
        raise ValueError(f"attention_block: d_model {d} not divisible by "
                         f"n_heads {n_heads}")
    w_qkv = helper.create_parameter(ParamAttr._to_attr(param_attr_qkv),
                                    [d, 3 * d], x.dtype)
    w_o = helper.create_parameter(ParamAttr._to_attr(param_attr_out),
                                  [d, d], x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "attention_block", {"X": x, "WQKV": w_qkv, "WO": w_o}, {"Out": out},
        {"n_heads": int(n_heads),
         "scale": float(scale if scale is not None
                        else (d // n_heads) ** -0.5),
         "causal": bool(causal)})
    return out


def ffn_block(x, d_inner, param_attr_fc1=None, bias_attr_fc1=None,
              param_attr_fc2=None, bias_attr_fc2=None, name=None):
    """The whole position-wise MLP (relu between two fcs, no dropout) as
    one op, in place of the mul/add/relu/mul/add sequence: the entry point
    of the ffn_block kernels. models/transformer routes _ffn here under
    PADDLE_TPU_FUSE_ATTN_BLOCK=1."""
    helper = LayerHelper("ffn_block", input=x, param_attr=param_attr_fc1,
                         name=name)
    d = int(x.shape[-1])
    w1 = helper.create_parameter(ParamAttr._to_attr(param_attr_fc1),
                                 [d, d_inner], x.dtype)
    b1 = helper.create_parameter(ParamAttr._to_attr(bias_attr_fc1),
                                 [d_inner], x.dtype, is_bias=True)
    w2 = helper.create_parameter(ParamAttr._to_attr(param_attr_fc2),
                                 [d_inner, d], x.dtype)
    b2 = helper.create_parameter(ParamAttr._to_attr(bias_attr_fc2), [d],
                                 x.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("ffn_block",
                     {"X": x, "W1": w1, "B1": b1, "W2": w2, "B2": b2},
                     {"Out": out}, {})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """reference layers/nn.py dropout: Out and a Mask of x's dtype (the
    grad reads the Mask); a `seed` pins the draw."""
    helper = LayerHelper("dropout", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("dropout", {"X": x}, {"Out": out, "Mask": mask},
                     {"dropout_prob": dropout_prob, "is_test": is_test,
                      "seed": seed or 0,
                      "dropout_implementation": dropout_implementation})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1,
                               label_smooth_eps=0.0):
    """Fused softmax + cross-entropy over the last axis; Loss is
    [..., 1]. Hard labels ([..., 1] int) go to the xent kernels."""
    if axis not in (-1, len(logits.shape) - 1):
        raise NotImplementedError(
            "softmax_with_cross_entropy: only the last axis")
    helper = LayerHelper("softmax_with_cross_entropy", input=logits)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    sm = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": logits, "Label": label},
                     {"Loss": loss, "Softmax": sm},
                     {"soft_label": soft_label,
                      "ignore_index": ignore_index,
                      "label_smooth_eps": label_smooth_eps})
    if return_softmax:
        return loss, sm
    return loss


def mean(x, name=None):
    """The mean of all elements, shape [1]."""
    helper = LayerHelper("mean", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", {"X": x}, {"Out": out}, {})
    return out


def _single(op_type, x, attrs=None, dtype=None, name=None):
    helper = LayerHelper(op_type, input=x, name=name)
    out = helper.create_variable_for_type_inference(dtype or x.dtype)
    helper.append_op(op_type, {"X": x}, {"Out": out}, attrs or {})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    return _single("softmax", input, {"axis": axis}, name=name)


def relu(x, name=None):
    return _single("relu", x, name=name)


def clip(x, min, max, name=None):
    """x limited to [min, max]."""
    return _single("clip", x, {"min": min, "max": max}, name=name)


def clip_by_norm(x, max_norm, name=None):
    """x scaled down to L2 norm max_norm where its norm is larger."""
    return _single("clip_by_norm", x, {"max_norm": max_norm}, name=name)


def _make_elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, input=x, act=act, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, {"X": x, "Y": y}, {"Out": out},
                         {"axis": axis})
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _make_elementwise("elementwise_add")
elementwise_sub = _make_elementwise("elementwise_sub")
elementwise_mul = _make_elementwise("elementwise_mul")
elementwise_div = _make_elementwise("elementwise_div")
elementwise_max = _make_elementwise("elementwise_max")
elementwise_min = _make_elementwise("elementwise_min")
elementwise_pow = _make_elementwise("elementwise_pow")
elementwise_mod = _make_elementwise("elementwise_mod")


def topk(input, k, name=None):
    """The k largest values of each row along the last axis and their
    int32 indices (the ``top_k`` op)."""
    helper = LayerHelper("top_k", input=input, name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("top_k", {"X": input},
                     {"Out": values, "Indices": indices}, {"k": k})
    return values, indices


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    if dim is None:
        attrs = {"dim": [0], "reduce_all": True, "keep_dim": keep_dim}
    else:
        if not isinstance(dim, (list, tuple)):
            dim = [dim]
        attrs = {"dim": list(dim), "reduce_all": False,
                 "keep_dim": keep_dim}
    return _single("reduce_sum", input, attrs, name=name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    if dim is None:
        attrs = {"dim": [0], "reduce_all": True, "keep_dim": keep_dim}
    else:
        if not isinstance(dim, (list, tuple)):
            dim = [dim]
        attrs = {"dim": list(dim), "reduce_all": False,
                 "keep_dim": keep_dim}
    return _single("reduce_max", input, attrs, name=name)


def one_hot(input, depth):
    """float32 one-hot rows of `depth` over int ids."""
    return _single("one_hot", input, {"depth": depth}, dtype="float32")


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper("matmul", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", {"X": x, "Y": y}, {"Out": out},
                     {"transpose_X": transpose_x,
                      "transpose_Y": transpose_y, "alpha": alpha})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper("reshape2", input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape2", {"X": x}, {"Out": out},
                     {"shape": list(shape)})
    return helper.append_activation(out)


def unsqueeze(input, axes, name=None):
    return _single("unsqueeze2", input, {"axes": list(axes)}, name=name)


def transpose(x, perm, name=None):
    return _single("transpose2", x, {"axis": list(perm)}, name=name)


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", input=input[0], name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", {"X": input}, {"Out": out}, {"axis": axis})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", input=input, name=name)
    axis = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": axis}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections),
                 "axis": axis}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op("split", {"X": input}, {"Out": outs}, attrs)
    return outs


def argmax(x, axis=0):
    return _single("arg_max", x, {"axis": axis}, dtype="int64")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", {"X": x}, {"Out": out},
                     {"scale": scale, "bias": bias,
                      "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def cast(x, dtype):
    dtype = as_datatype(dtype)
    return _single("cast", x, {"out_dtype": dtype.value}, dtype=dtype)


def increment(x, value=1.0, in_place=True):
    # integer counters stay integers (nn.py increment in the JAX
    # package coerces an integral float step the same way)
    dt = getattr(x.dtype, "value", x.dtype)
    if isinstance(value, float) and isinstance(dt, str) \
            and dt.startswith(("int", "uint")) and value.is_integer():
        value = int(value)
    helper = LayerHelper("increment", input=x)
    out = x if in_place else \
        helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", {"X": x}, {"Out": out},
                     {"step": value})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", {"X": input, "Index": index},
                     {"Out": out}, {})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    """`input` with the rows at `index` set to (`overwrite`) or added to
    by `updates`."""
    helper = LayerHelper("scatter", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("scatter",
                     {"X": input, "Ids": index, "Updates": updates},
                     {"Out": out}, {"overwrite": overwrite})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    """Normal values of `shape` (a nonzero `seed` pins the draw)."""
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("gaussian_random", {}, {"Out": out},
                     {"shape": list(shape), "mean": mean, "std": std,
                      "seed": seed, "dtype": as_datatype(dtype).value})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("expand", {"X": x}, {"Out": out},
                     {"expand_times": list(expand_times)})
    return out


def masked_pool_write(pool, new, index, gate=None, leading_dims=1,
                      exclusive_via=None, name=None):
    """Write rows into a shared decode KV pool in place (the op's Out
    is the pool var itself; ops/paged_ops.py). ``exclusive_via`` names
    why the rows cannot alias: "block_table" (per-lane blocks from the
    host free list; needs ``gate`` so idle, dustbin and paused lanes
    write nothing), "host_indices" (host-deduplicated admission
    targets) or "cow_dst" (fresh exclusive blocks of a copy)."""
    if exclusive_via not in ("block_table", "host_indices", "cow_dst"):
        raise ValueError(
            f"masked_pool_write needs exclusive_via='block_table', "
            f"'host_indices' or 'cow_dst' (got {exclusive_via!r}): "
            f"shared-pool writes must declare why row indices cannot "
            f"alias")
    if exclusive_via == "block_table" and gate is None:
        raise ValueError(
            "masked_pool_write(exclusive_via='block_table') needs a "
            "gate: ungated lane writes through a block table let "
            "idle/dustbin lanes scribble over other requests' KV")
    helper = LayerHelper("masked_pool_write", input=pool, name=name)
    inputs = {"Pool": pool, "New": new, "Index": index}
    if gate is not None:
        inputs["Gate"] = gate
    helper.append_op("masked_pool_write", inputs, {"Out": pool},
                     {"leading_dims": int(leading_dims),
                      "exclusive_via": exclusive_via})
    return pool


def paged_decode_attention(q, pool_k, pool_v, block_tab, step, scale=1.0,
                           name=None):
    """Single-query attention of q [R,H,1,Dh] over each lane's cache
    positions <= step [R] in the shared pools [NB,BS,H,Dh], through the
    block table [R,NP] (ops/paged_ops.py). Returns [R,H,1,Dh]."""
    helper = LayerHelper("paged_decode_attention", input=q, name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op("paged_decode_attention",
                     {"Q": q, "PoolK": pool_k, "PoolV": pool_v,
                      "BlockTab": block_tab, "Step": step},
                     {"Out": out}, {"scale": float(scale)})
    return out


def filtered_softmax(logits, temperature=1.0, top_k=0, top_p=1.0,
                     name=None):
    """Temperature/top-k/top-p filtered, renormalized probabilities over
    the last axis of `logits` (ops/spec_ops.py). temperature=0 is the
    greedy case: a one-hot at the argmax."""
    helper = LayerHelper("filtered_softmax", input=logits, name=name)
    out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("filtered_softmax", {"X": logits}, {"Out": out},
                     {"temperature": float(temperature),
                      "top_k": int(top_k), "top_p": float(top_p)})
    return out


def sample_categorical(probs, seed, pos, noise_tag=0, base_seed=0,
                       name=None):
    """One token a lane from [R, V] probabilities (ops/spec_ops.py). The
    noise is a pure function of (base_seed, noise_tag, seed[r], pos[r]),
    not of the executor's step key, so the same (request seed, position)
    draws the same token in every serve program: admission order, burst
    boundaries and preemption replay cannot move a sampled token."""
    helper = LayerHelper("sample_categorical", input=probs, name=name)
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("sample_categorical",
                     {"Probs": probs, "Seed": seed, "Pos": pos},
                     {"Out": out},
                     {"noise_tag": int(noise_tag),
                      "base_seed": int(base_seed)})
    return out


def span_scatter(buf, vals, start, count, name=None):
    """buf[r, start[r]:start[r]+count[r]] = vals[r, :count[r]], into the
    buf var itself: the speculative step's accepted-prefix token write
    (ops/spec_ops.py)."""
    helper = LayerHelper("span_scatter", input=buf, name=name)
    helper.append_op("span_scatter",
                     {"X": buf, "Vals": vals, "Start": start,
                      "Count": count}, {"Out": buf}, {})
    return buf


def spec_accept(proposals, draft_probs, target_probs, seed, pos, k,
                end_id, max_len, greedy=True, base_seed=0, noise_tag=0,
                name=None):
    """Draft-and-verify acceptance for one batched speculative step
    (ops/spec_ops.py; greedy=True is token-exact greedy). Returns
    (advance, tokens, accepted, fin)."""
    helper = LayerHelper("spec_accept", input=proposals, name=name)
    outs = [helper.create_variable_for_type_inference("int64", True)
            for _ in range(4)]
    helper.append_op("spec_accept",
                     {"Proposals": proposals, "DraftProbs": draft_probs,
                      "TargetProbs": target_probs, "Seed": seed,
                      "Pos": pos},
                     dict(zip(("Advance", "Tokens", "Accepted", "Fin"),
                              outs)),
                     {"k": int(k), "end_id": int(end_id),
                      "max_len": int(max_len), "greedy": bool(greedy),
                      "base_seed": int(base_seed),
                      "noise_tag": int(noise_tag)})
    return tuple(outs)
