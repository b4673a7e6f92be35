"""NN ops of the serving and training slices: conv2d, depthwise_conv2d
and pool2d, layer_norm, softmax, softmax_with_cross_entropy,
lookup_table, dropout, attention and the fused attention_block and
ffn_block, the accuracy metric and the inference passes' fc (the subset
of ``paddle_tpu/ops/nn_ops.py`` the paths run; reference conv_op.cc,
pool_op.cc, layer_norm_op.cc, softmax_op.cc,
softmax_with_cross_entropy_op.cc, lookup_table_op.cc, dropout_op.cc,
metrics/accuracy_op.cc).

The JAX package computes the convolutions and poolings in XLA, outside
any Pallas kernel, so here they call ``F.conv2d``, ``F.max_pool2d`` and
``F.avg_pool2d`` as the products call ``torch.matmul``. On the card
cuDNN runs them with TF32 off and its deterministic algorithms only
(``_cudnn_exact``): a training step repeats bit for bit.

layer_norm, attention, attention_block, ffn_block and
softmax_with_cross_entropy (hard labels) route to the hand-written kernels
in ``ops/kernels``; each kernel wrapper launches on a CUDA tensor and runs
its plain version on a CPU one.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.program import Operator, grad_var_name
from ..core.registry import make_vjp_grad_kernel, register_op
from .kernels import attention as K_attn
from .kernels import attention_block as K_ab
from .kernels import ffn_block as K_ffn
from .kernels import layer_norm as K_ln
from .kernels import reference_attention
from .kernels import xent as K_xent
from .math_ops import _flatten2d
from .tensor_ops import _take_fill


def _layer_norm(ctx, affine):
    """Statistics in fp32 whatever the input dtype (nn_ops.py:410 in the
    JAX package); Mean and Variance are [lead]. `affine` computes the
    rows when both Scale and Bias are given: the kernel wrapper or its
    plain version."""
    x = ctx.input("X")
    eps = ctx.attr("epsilon", 1e-5)
    begin = ctx.attr("begin_norm_axis", 1)
    lead = int(np.prod(x.shape[:begin]))
    x2 = x.reshape(lead, -1)
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    if scale is not None and bias is not None:
        y, mean, var = affine(x2.contiguous(), scale.reshape(-1),
                              bias.reshape(-1), eps)
        return {"Y": y.reshape(x.shape), "Mean": mean, "Variance": var}
    x2f = x2.float()
    mean = x2f.mean(dim=1, keepdim=True)
    var = (x2f - mean).square().mean(dim=1, keepdim=True)
    y = (x2f - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.reshape(1, -1).float()
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return {"Y": y.to(x.dtype).reshape(x.shape),
            "Mean": mean.reshape(lead), "Variance": var.reshape(lead)}


@register_op("layer_norm")
def layer_norm(ctx):
    return _layer_norm(ctx, K_ln.layer_norm)


def _pair(v):
    return [int(x) for x in v] if isinstance(v, (list, tuple)) \
        else [int(v), int(v)]


def _cudnn_exact(x):
    """On the card: no TF32 in cuDNN and no algorithm that sums with
    atomics (a weight gradient's split reductions), nor one picked by
    timing, so a conv step gives the same bits every time."""
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


@register_op("conv2d")
def conv2d(ctx):
    """NCHW input, OIHW filter ([out_c, in_c / groups, kh, kw]),
    symmetric `paddings`, `strides`, `dilations` and `groups`
    (``lax.conv_general_dilated`` in the JAX package)."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    _cudnn_exact(x)
    out = F.conv2d(x, w, stride=_pair(ctx.attr("strides", [1, 1])),
                   padding=_pair(ctx.attr("paddings", [0, 0])),
                   dilation=_pair(ctx.attr("dilations", [1, 1])),
                   groups=int(ctx.attr("groups", 1)))
    return {"Output": out}


@register_op("depthwise_conv2d")
def depthwise_conv2d(ctx):
    """conv2d with `groups` the input's channels, as the JAX package
    computes it."""
    return conv2d(ctx)


@register_op("pool2d")
def pool2d(ctx):
    """Max or average pooling over NCHW windows (``_pool2d_impl`` in the
    JAX package, a ``reduce_window``): `global_pooling` takes the whole
    plane; padding is -inf for max and 0 for avg, an avg over padded
    windows divides by the valid count when `exclusive`, else by the
    window's size. `ceil_mode` is taken and ignored, as there. A max's
    gradient goes to the first maximum of its window, as JAX's
    select-and-scatter sends it."""
    x = ctx.input("X")
    ksize = _pair(ctx.attr("ksize", [2, 2]))
    strides = _pair(ctx.attr("strides", [1, 1]))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    if ctx.attr("global_pooling", False):
        ksize, pads, strides = [x.shape[2], x.shape[3]], [0, 0], [1, 1]
    _cudnn_exact(x)
    padded = pads[0] or pads[1]
    if ctx.attr("pooling_type", "max") == "max":
        if padded:
            x = F.pad(x, (pads[1], pads[1], pads[0], pads[0]),
                      value=float("-inf"))
        return F.max_pool2d(x, ksize, strides)
    if padded:
        x = F.pad(x, (pads[1], pads[1], pads[0], pads[0]))
    s = F.avg_pool2d(x, ksize, strides, divisor_override=1)
    if padded and ctx.attr("exclusive", True):
        ones = F.pad(torch.ones_like(ctx.input("X")),
                     (pads[1], pads[1], pads[0], pads[0]))
        return s / F.avg_pool2d(ones, ksize, strides, divisor_override=1)
    return s / (ksize[0] * ksize[1])


# The grad recomputes the forward with the plain version and takes its
# vjp, as the JAX package's custom_vjp does: a vjp through the kernel
# would launch it and throw its output away.
register_op("layer_norm_grad", differentiable=False)(make_vjp_grad_kernel(
    "layer_norm", lambda ctx: _layer_norm(ctx, K_ln.layer_norm_plain)))


@register_op("softmax")
def softmax(ctx):
    return torch.softmax(ctx.input("X"), dim=ctx.attr("axis", -1))


def _lookup_grad_maker(op, no_grad_set=frozenset()):
    """The embedding grad is a scatter-add into a dense [V, D] grad
    (nn_ops.py `_lookup_grad_maker` in the JAX package)."""
    w = op.inputs["W"][0]
    if w in no_grad_set:
        return []
    inputs = {"W": op.inputs["W"], "Ids": op.inputs["Ids"],
              "Out@GRAD": [grad_var_name(n) for n in op.outputs["Out"]]}
    return [Operator(op.block, "lookup_table_grad", inputs,
                     {"W@GRAD": [grad_var_name(w)]}, dict(op.attrs))]


def _lookup_rows(ctx, v):
    """Ids as int64 with a trailing 1 dropped, those ids clamped into
    [0, V) and whether each named a row: an id in [-V, 0) counts from
    the end, any other outside [0, V) names none (``jnp.take``'s fill
    mode in the forward, ``.at[ids].add`` in the grad). Clamping and
    masking need no device assert and no host sync on the card."""
    ids = ctx.input("Ids").long()
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    wrapped = torch.where(ids < 0, ids + v, ids)
    valid = (wrapped >= 0) & (wrapped < v)
    return ids, torch.where(valid, wrapped, 0), valid


def _padding_keep(ctx, ids, dtype):
    """1 where the raw id is not `padding_idx` (an id of -1 or None
    pads nothing), as a column of `dtype`; None when nothing pads."""
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is None or padding_idx < 0:
        return None
    return (ids != padding_idx).to(dtype)[..., None]


@register_op("lookup_table_grad", differentiable=False)
def _lookup_grad_kernel(ctx):
    w = ctx.input("W")
    ids, rows, valid = _lookup_rows(ctx, w.shape[0])
    dy = ctx.input("Out@GRAD").reshape(*ids.shape, w.shape[-1]).to(w.dtype)
    dy = torch.where(valid[..., None], dy, 0)
    pad = _padding_keep(ctx, ids, w.dtype)
    if pad is not None:
        dy = dy * pad
    # index_put_ with accumulate sorts the ids and sums each row's
    # duplicates in their order: the same bits on every run, where
    # index_add_'s atomic adds on the card sum them in any order
    return {"W@GRAD": torch.zeros_like(w).index_put_(
        (rows.reshape(-1),), dy.reshape(-1, w.shape[-1]), accumulate=True)}


@register_op("lookup_table", grad_maker=_lookup_grad_maker)
def lookup_table(ctx):
    w = ctx.input("W")
    ids, rows, valid = _lookup_rows(ctx, w.shape[0])
    out = torch.where(valid[..., None], w[rows], _take_fill(w.dtype))
    pad = _padding_keep(ctx, ids, w.dtype)
    return out if pad is None else out * pad


def _hard_labels(logits, label):
    """[..., V] logits and [..., 1] or [...] labels as [N, V] and [N]."""
    lab = label[..., 0] if label.dim() == logits.dim() else label
    v = logits.shape[-1]
    return logits.reshape(-1, v).contiguous(), lab.reshape(-1)


def _swce_grad_maker(op, no_grad_set=frozenset()):
    """The grad is recomputed from the saved Logits, so the forward's
    Softmax output need not exist (nn_ops.py `_swce_grad_maker` in the
    JAX package)."""
    inputs = {"Logits": op.inputs["Logits"], "Label": op.inputs["Label"],
              "Loss@GRAD": [grad_var_name(n) for n in op.outputs["Loss"]]}
    outputs = {"Logits@GRAD": [grad_var_name(n)
                               for n in op.inputs["Logits"]]}
    return [Operator(op.block, "softmax_with_cross_entropy_grad", inputs,
                     outputs, dict(op.attrs))]


@register_op("softmax_with_cross_entropy_grad", differentiable=False)
def _swce_grad_kernel(ctx):
    """(softmax - target)·dloss in the logits' dtype. Hard labels go to
    the xent backward kernel; soft labels stay plain PyTorch, as they
    stay plain jnp in the JAX package."""
    logits = ctx.input("Logits")
    label = ctx.input("Label")
    dloss = ctx.input("Loss@GRAD")
    if dloss is None:
        dloss = torch.ones(logits.shape[:-1] + (1,), dtype=torch.float32,
                           device=logits.device)
    eps = ctx.attr("label_smooth_eps", 0.0)
    if not ctx.attr("soft_label", False):
        l2, lab1 = _hard_labels(logits, label)
        dx = K_xent.xent_backward(l2, lab1, dloss.reshape(-1), eps=eps,
                                  ignore_index=ctx.attr("ignore_index",
                                                        -100))
        return {"Logits@GRAD": dx.reshape(logits.shape)}
    lf = logits.float()
    vocab = lf.shape[-1]
    target = label.float()
    if eps:
        target = target * (1.0 - eps) + eps / vocab
    d = dloss.float()
    grad = torch.softmax(lf, dim=-1) * d - target * d
    return {"Logits@GRAD": grad.to(logits.dtype)}


@register_op("softmax_with_cross_entropy", grad_maker=_swce_grad_maker)
def softmax_with_cross_entropy(ctx):
    """loss = lse(logits) - logits[label], with label smoothing and
    ignore_index; Loss is [..., 1]. Hard labels go to the xent forward
    kernel. The Softmax output, an [N, V] fp32 buffer, is computed only
    when something reads it: the JAX package leaves it to XLA to
    dead-code, and at Transformer-base's [16384, 32000] it would be
    2.1 GB a step.

    A hard label outside [0, V) that is not ignore_index picks no
    logit, so its loss is the lse: the rule of the Pallas kernel
    (``paddle_tpu/ops/pallas/xent.py``, ``cols == lab``), on both
    devices. The JAX package's XLA path (``take_along_axis``) instead
    gives NaN for a label >= V and wraps a negative one, so its CPU
    loss is no oracle for such labels."""
    logits = ctx.input("Logits")
    label = ctx.input("Label")
    eps = ctx.attr("label_smooth_eps", 0.0)
    lead = logits.shape[:-1] + (1,)
    if not ctx.attr("soft_label", False):
        l2, lab1 = _hard_labels(logits, label)
        loss, lse = K_xent.xent_forward(
            l2, lab1, eps=eps, ignore_index=ctx.attr("ignore_index", -100))
        out = {"Loss": loss.reshape(lead)}
        if ctx.output_needed("Softmax"):
            out["Softmax"] = torch.exp(logits.float() - lse.reshape(lead))
        return out
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    loss = lse - torch.sum(label.float() * lf, dim=-1, keepdim=True)
    if eps:
        loss = (1.0 - eps) * loss + eps * (lse - lf.mean(-1, keepdim=True))
    out = {"Loss": loss}
    if ctx.output_needed("Softmax"):
        out["Softmax"] = torch.exp(lf - lse)
    return out


# --------------------------------------------------------------------------
# dropout (the mask saved for the grad, reference dropout_op.cc)
# --------------------------------------------------------------------------
def _dropout_grad_maker(op, no_grad_set=frozenset()):
    """dropout_grad reads the forward's Mask, never a redraw (nn_ops.py
    `_dropout_grad_maker` in the JAX package)."""
    inputs = {"Mask": op.outputs["Mask"],
              "Out@GRAD": [grad_var_name(n) for n in op.outputs["Out"]]}
    outputs = {"X@GRAD": [grad_var_name(n) for n in op.inputs["X"]]}
    return [Operator(op.block, "dropout_grad", inputs, outputs,
                     dict(op.attrs))]


@register_op("dropout_grad", differentiable=False)
def _dropout_grad_kernel(ctx):
    dy = ctx.input("Out@GRAD")
    mask = ctx.input("Mask")
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        if impl == "upscale_in_train":
            return {"X@GRAD": dy}
        return {"X@GRAD": dy * (1.0 - p)}
    if impl == "upscale_in_train":
        return {"X@GRAD": dy * mask * (1.0 / max(1.0 - p, 1e-8))}
    return {"X@GRAD": dy * mask}


@register_op("dropout", grad_maker=_dropout_grad_maker, needs_rng=True)
def dropout(ctx):
    """Out = X * Mask (/ (1 - p) with upscale_in_train); Mask in X's
    dtype, 1 with probability 1 - p, drawn on X's device from the device
    step key (``OpContext.keep_mask``), so a captured step draws anew at
    each replay; a nonzero `seed` attr pins the draw. At is_test, X (or
    X (1 - p)) and a Mask of ones."""
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": out, "Mask": torch.ones_like(x)}
    keep = ctx.keep_mask(x.shape, 1.0 - p, x.dtype, x.device,
                         seed=ctx.attr("seed", 0))
    if impl == "upscale_in_train":
        out = x * keep / max(1.0 - p, 1e-8)
    else:
        out = x * keep
    return {"Out": out, "Mask": keep}


def _sdpa(q, k, v, scale, causal, layout, keep=None, rate=0.0):
    """The plain masked-softmax composition (the JAX package's `_sdpa`):
    fp32 scores, finfo.min masking, bottom-right causal alignment; P
    rounded to the input dtype before the P v product, which accumulates
    in fp32 (``p.astype(q.dtype)``, ``preferred_element_type=float32``).
    With `keep`, a [B,H,tq,tk] keep mask, dropout on P after the softmax
    (P keep / (1 - rate))."""
    if layout == "bthd":
        qk, pv = "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd"
    else:
        qk, pv = "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd"
    s = torch.einsum(qk, q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=s.device).tril(tk - tq)
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = p * keep / (1.0 - rate)
    return torch.einsum(pv, p.to(q.dtype).float(), v.float()).to(q.dtype)


def _route(qh, kh, vh):
    """Which kernel takes these [B,H,T,D] shapes (nn_ops.py:1034-1061 in
    the JAX package, without the TPU tile conditions): 'sdpa_short',
    'flash', or None for the plain composition. The kernels take q, k, v
    all fp32 or all bf16, as `usable` and `sdpa_usable` ask for matching
    dtypes; a routed call on the card launches the kernel or raises."""
    tq, d = qh.shape[2], qh.shape[3]
    tk = kh.shape[2]
    if not (qh.dtype == kh.dtype == vh.dtype
            and qh.dtype in K_attn.DTYPES):
        return None
    if tq == tk and 256 < tq <= K_attn.SDPA_MAX_T \
            and d in K_attn.SDPA_HEAD_DIMS:
        return "sdpa_short"
    if tq > 512 and d in K_attn.FLASH_HEAD_DIMS:
        return "flash"
    return None


@register_op("attention", needs_rng=True)
def attention(ctx):
    """layout attr: 'bhtd' (default) or 'bthd' ([B,T,H,D] straight from
    the head-split reshape). On the card a kernel-routed call (T > 256,
    fp32 or bf16) is differentiable: attention_grad's vjp recompute
    launches the forward kernel again with its residual (P or lse) and
    then the backward kernel(s), as `jax.vjp` of the op re-runs
    `_flash_fwd` in the JAX package. A nonzero `dropout_rate` outside
    is_test takes the inline composition with the keep mask on P after
    the softmax and no kernel, as in the JAX package; the mask comes
    from the device step key, and the grad op's recompute draws the
    forward's mask again."""
    q, k, v = ctx.input("Q"), ctx.input("K"), ctx.input("V")
    scale = ctx.attr("scale", None)
    causal = ctx.attr("causal", False)
    layout = ctx.attr("layout", "bhtd")
    rate = 0.0 if ctx.attr("is_test", False) \
        else ctx.attr("dropout_rate", 0.0)
    if scale is None:
        scale = q.shape[-1] ** -0.5

    def to_bhtd(x):
        return x.transpose(1, 2) if layout == "bthd" else x

    qh, kh, vh = to_bhtd(q), to_bhtd(k), to_bhtd(v)
    if rate:
        b, h, tq, tk = qh.shape[0], qh.shape[1], qh.shape[2], kh.shape[2]
        keep = ctx.keep_mask((b, h, tq, tk), 1.0 - rate, torch.float32,
                             q.device)
        return to_bhtd(_sdpa(qh, kh, vh, scale, causal, "bhtd", keep, rate))
    route = _route(qh, kh, vh)
    if route is not None:
        kern = K_attn.sdpa_short if route == "sdpa_short" \
            else K_attn.flash_attention
        out = kern(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                   float(scale), bool(causal))
        return to_bhtd(out)
    if layout == "bthd":
        return _sdpa(q, k, v, scale, causal, "bthd")
    return reference_attention(q, k, v, scale, causal)


@register_op("fc")
def fc(ctx):
    """mul + bias + activation as one op (``fc`` in the JAX package's
    nn_ops.py, which ``ir.fc_fuse_pass`` writes, as the reference's
    ir/fc_fuse_pass.cc does): Input flattened to 2-D at
    `in_num_col_dims`, times W, plus Bias when given, the leading dims
    restored, then `activation_type` relu, tanh or softmax ("" none).
    A plain product, as in the JAX package, where it runs outside any
    Pallas kernel."""
    x, w, b = ctx.input("Input"), ctx.input("W"), ctx.input("Bias")
    ncd = ctx.attr("in_num_col_dims", 1)
    x2 = _flatten2d(x, ncd)
    out = torch.matmul(x2, w.reshape(x2.shape[-1], -1))
    if b is not None:
        out = out + b.reshape(1, -1)
    out = out.reshape(tuple(x.shape[:ncd]) + (out.shape[-1],))
    act = ctx.attr("activation_type", "")
    if act == "relu":
        out = torch.relu(out)
    elif act == "tanh":
        out = torch.tanh(out)
    elif act == "softmax":
        out = torch.softmax(out, dim=-1)
    elif act:
        raise ValueError(f"fc: unsupported activation {act!r}")
    return {"Out": out}


@register_op("ffn_block")
def ffn_block(ctx):
    """The whole position-wise MLP sub-layer as one op, relu(x W1 + b1) W2
    + b2 (nn_ops.py `ffn_block_op` in the JAX package). Shapes and dtypes
    the JAX package's gate takes (fp32 or bf16) go to the kernel wrapper,
    others to the plain composition; on the card a bf16 call launches the
    bf16 kernels (wgmma fed by TMA), an fp32 call the split-TF32 ones.
    Its grad comes from the generic vjp, which on the card runs the
    forward kernel and then the backward kernel."""
    x = ctx.input("X")
    args = (x, ctx.input("W1"), ctx.input("B1"), ctx.input("W2"),
            ctx.input("B2"))
    if K_ffn.usable(x, args[1]):
        return {"Out": K_ffn.ffn_block(*(a.contiguous() for a in args))}
    return {"Out": K_ffn.ffn_block_plain(*args)}


@register_op("attention_block")
def attention_block(ctx):
    """The whole self-attention sub-layer as one op: x Wqkv -> split-heads
    attention -> merge -> Wo (nn_ops.py `attention_block_op` in the JAX
    package), in place of the seven ops multi_head_attention otherwise
    emits. Shapes and dtypes the JAX package's gate takes (fp32 or bf16)
    go to the kernel wrapper, others to the plain composition; on the card
    a bf16 call launches the kernels' bf16 instances, an fp32 call their
    split-TF32 ones. Its grad comes from the generic vjp, which on the
    card runs the forward kernel with P saved and then the backward
    kernel (no exp)."""
    x, wqkv, wo = ctx.input("X"), ctx.input("WQKV"), ctx.input("WO")
    n_heads = int(ctx.attr("n_heads"))
    scale = ctx.attr("scale", None)
    if scale is None:
        scale = (x.shape[-1] // n_heads) ** -0.5
    causal = bool(ctx.attr("causal", False))
    if K_ab.usable(x, wqkv, n_heads):
        out = K_ab.attention_block(x.contiguous(), wqkv.contiguous(),
                                   wo.contiguous(), n_heads, float(scale),
                                   causal)
    else:
        out = K_ab.attention_block_plain(x, wqkv, wo, n_heads, float(scale),
                                         causal)
    return {"Out": out}


@register_op("accuracy", differentiable=False)
def accuracy(ctx):
    """The share of rows whose Label is among their top-k Indices
    (reference metrics/accuracy_op.cc; ``paddle_tpu/ops/nn_ops.py``
    accuracy): Accuracy float32 [1], Correct and Total int32 [1]. Total
    comes from the shape, so no value crosses to the host and a captured
    step can fetch all three."""
    indices = ctx.input("Indices")
    label = ctx.input("Label").to(indices.dtype)
    if label.dim() == 1:
        label = label[:, None]
    correct = torch.any(indices == label, dim=-1)
    total = correct.shape[0]
    num_correct = torch.sum(correct.to(torch.float32))
    return {"Accuracy": (num_correct / total).reshape(1),
            "Correct": num_correct.to(torch.int32).reshape(1),
            "Total": torch.full((1,), total, dtype=torch.int32,
                                device=indices.device)}
