"""IR graph + pass framework over Programs (the port's counterpart of
``paddle_tpu/ir.py``; reference paddle/fluid/framework/ir/: ir::Graph
graph.h:72, ir::Pass pass.h:34, and the fuse passes conv_bn_fuse_pass.cc,
fc_fuse_pass.cc, ...).

The passes rewrite a Program's global block in place and, where a fold
changes parameter values (conv_bn_fuse), write the folded tensors into
the scope, computed with torch on the scope's values. Each pass rewrites
a program exactly as the JAX package's pass of the same name does:
  - dropout_eliminate: removes is_test dropout ops from a serving
    program,
  - conv_bn_fuse: folds inference batch_norm into the conv weights,
  - fc_fuse: mul + elementwise_add (+relu) -> one fc op,
  - attention_fuse: the matmul/scale/softmax/matmul composition -> one
    attention op,
  - identity_elimination, conv_relu_fuse, conv_eltwiseadd_fuse, and the
    optimizer fusions fuse_sgd_op / fuse_adam_op.
The conv passes write conv2d_fusion, an op the port does not run yet.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .core.program import Block, Operator, Program

__all__ = ["Graph", "Node", "Pass", "register_pass", "get_pass",
           "apply_passes", "PassRegistry"]


class Node:
    """Graph node: either an op or a var (reference ir/node.h)."""

    def __init__(self, kind: str, name: str, op: Optional[Operator] = None):
        self.kind = kind  # "op" | "var"
        self.name = name
        self.op = op
        self.inputs: List["Node"] = []
        self.outputs: List["Node"] = []

    def is_op(self):
        return self.kind == "op"

    def is_var(self):
        return self.kind == "var"

    def __repr__(self):
        return f"Node({self.kind}:{self.name})"


class Graph:
    """Dependency graph of one Block (reference ir/graph.h:72).

    Var nodes are SSA-versioned: each write creates a fresh var node, so
    consumers link to the exact producing op (the reference achieves the
    same with unique ir::Node instances per var occurrence).
    """

    def __init__(self, program: Program, block_idx: int = 0):
        self.program = program
        self.block: Block = program.blocks[block_idx]
        self.attrs: Dict = {}
        self.rebuild()

    def rebuild(self):
        self.op_nodes: List[Node] = []
        self.var_nodes: List[Node] = []
        latest: Dict[str, Node] = {}
        for op in self.block.ops:
            on = Node("op", op.type, op)
            self.op_nodes.append(on)
            for name in op.input_arg_names:
                vn = latest.get(name)
                if vn is None:
                    vn = Node("var", name)
                    self.var_nodes.append(vn)
                    latest[name] = vn
                vn.outputs.append(on)
                on.inputs.append(vn)
            for name in op.output_arg_names:
                vn = Node("var", name)
                self.var_nodes.append(vn)
                latest[name] = vn
                vn.inputs.append(on)
                on.outputs.append(vn)
        self._latest = latest

    # --- query helpers (GraphPatternDetector-style) -------------------
    def producer(self, op: Operator, slot: str) -> Optional[Operator]:
        """The op producing `op.inputs[slot][0]`, or None if it's a
        feed/param."""
        names = op.input(slot)
        if not names:
            return None
        target = names[0]
        idx = self.block.ops.index(op)
        for prev in reversed(self.block.ops[:idx]):
            if target in prev.output_arg_names:
                return prev
        return None

    def consumers(self, op: Operator, var_name: str) -> List[Operator]:
        """Ops after `op` reading var_name (before any re-write of it)."""
        idx = self.block.ops.index(op)
        out = []
        for nxt in self.block.ops[idx + 1:]:
            if var_name in nxt.input_arg_names:
                out.append(nxt)
            if var_name in nxt.output_arg_names:
                break
        return out

    # --- mutation helpers ---------------------------------------------
    def remove_op(self, op: Operator):
        self.block.ops.remove(op)

    def replace_input_everywhere(self, old: str, new: str,
                                 after: Optional[Operator] = None):
        start = 0 if after is None else self.block.ops.index(after) + 1
        for op in self.block.ops[start:]:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [new if n == old else n for n in names]

    def to_program(self) -> Program:
        return self.program


class Pass:
    """Base pass (reference ir/pass.h:34). Subclass and implement
    apply_impl(graph, scope)."""

    name = "pass"

    def apply(self, graph: Graph, scope=None) -> Graph:
        self.apply_impl(graph, scope)
        graph.rebuild()
        # any rewrite invalidates warm Executor caches keyed on
        # (id(program), program._version, ...) -- removal/rewire-only
        # passes would otherwise serve the stale pre-pass executable
        graph.program._version += 1
        return graph

    def apply_impl(self, graph: Graph, scope) -> None:
        raise NotImplementedError


class PassRegistry:
    _passes: Dict[str, Callable[[], Pass]] = {}

    @classmethod
    def register(cls, name: str, factory: Callable[[], Pass]):
        cls._passes[name] = factory

    @classmethod
    def get(cls, name: str) -> Pass:
        if name not in cls._passes:
            raise KeyError(f"pass {name!r} is not registered; have "
                           f"{sorted(cls._passes)}")
        return cls._passes[name]()

    @classmethod
    def has(cls, name: str) -> bool:
        return name in cls._passes


def register_pass(name: str):
    def deco(klass):
        klass.name = name
        PassRegistry.register(name, klass)
        return klass

    return deco


def get_pass(name: str) -> Pass:
    return PassRegistry.get(name)


def apply_passes(program: Program, pass_names: List[str], scope=None,
                 block_idx: int = 0, protected=None) -> Program:
    """`protected` vars (e.g. the predictor's fetch targets) must still
    be produced by the rewritten program — passes may not erase them."""
    graph = Graph(program, block_idx)
    graph.attrs["protected"] = set(protected or ())
    for name in pass_names:
        get_pass(name).apply(graph, scope)
    return graph.to_program()


# =====================================================================
# Passes
# =====================================================================
@register_pass("dropout_eliminate_pass")
class DropoutEliminatePass(Pass):
    """Remove is_test dropout ops (reference: the AnalysisPredictor
    pipeline's simplification passes; dropout at inference is identity
    for upscale_in_train, x*(1-p) for downgrade_in_infer)."""

    def apply_impl(self, graph: Graph, scope):
        for op in list(graph.block.ops):
            if op.type != "dropout" or not op.attr("is_test", False):
                continue
            x, = op.input("X")
            out, = op.output("Out")
            impl = op.attr("dropout_implementation", "downgrade_in_infer")
            if impl == "upscale_in_train":
                if out in graph.attrs.get("protected", ()):
                    # a fetched var must stay produced: an identity
                    # instead of rewiring it away
                    idx = graph.block.ops.index(op)
                    graph.remove_op(op)
                    graph.block.insert_op(idx, "assign", {"X": [x]},
                                          {"Out": [out]}, {})
                    continue
                graph.replace_input_everywhere(out, x, after=op)
                graph.remove_op(op)
            else:
                idx = graph.block.ops.index(op)
                graph.remove_op(op)
                graph.block.insert_op(
                    idx, "scale", {"X": [x]}, {"Out": [out]},
                    {"scale": 1.0 - op.attr("dropout_prob", 0.5),
                     "bias": 0.0})


@register_pass("conv_bn_fuse_pass")
class ConvBNFusePass(Pass):
    """Fold inference batch_norm into the preceding conv2d's weights
    (reference ir/conv_bn_fuse_pass.cc). Requires the scope holding the
    parameter values:  w' = w * gamma/sqrt(var+eps)   (per out-channel)
                       b' = beta - mean * gamma/sqrt(var+eps)
    The BN op is replaced by an elementwise_add of the new bias."""

    def apply_impl(self, graph: Graph, scope):
        if scope is None:
            return
        for bn in list(graph.block.ops):
            if bn.type != "batch_norm":
                continue
            if not (bn.attr("is_test", False)
                    or bn.attr("use_global_stats", False)):
                continue
            conv = graph.producer(bn, "X")
            add = None  # conv_eltwiseadd_bn pattern (reference
            # ir/conv_elementwise_add_fuse_pass-era variant): the conv2d
            # layer emits a separate per-channel bias add
            if (conv is not None and conv.type == "elementwise_add"
                    and conv.attr("axis", -1) == 1):
                add = conv
                conv = graph.producer(add, "X")
            if conv is None or conv.type != "conv2d":
                continue
            conv_out, = conv.output("Output")
            mid = add.output("Out")[0] if add is not None else conv_out
            # conv (and add) output must feed only this chain/BN
            nxt = add if add is not None else bn
            if [c is nxt for c in graph.consumers(conv, conv_out)] != [True]:
                continue
            if add is not None and [
                    c is bn for c in graph.consumers(add, mid)] != [True]:
                continue
            w_name = conv.input("Filter")[0]
            w = scope._get(w_name)
            gamma = scope._get(bn.input("Scale")[0])
            beta = scope._get(bn.input("Bias")[0])
            mean = scope._get(bn.input("Mean")[0])
            var = scope._get(bn.input("Variance")[0])
            if any(v is None for v in (w, gamma, beta, mean, var)):
                continue
            b0 = None
            if add is not None:  # validate bias BEFORE mutating weights
                b0 = scope._get(add.input("Y")[0])
                if b0 is None:
                    continue
            w, gamma, beta, mean, var = (torch.as_tensor(v) for v in (
                w, gamma, beta, mean, var))
            eps = bn.attr("epsilon", 1e-5)
            inv_std = gamma / torch.sqrt(var + eps)
            scope._set(w_name,
                       (w * inv_std[:, None, None, None]).to(w.dtype))
            bn_out, = bn.output("Y")
            if add is not None:
                # fold into the existing conv bias:
                # BN(conv+b0) = conv*s + (b0-mean)*s + beta
                b_name = add.input("Y")[0]
                b0 = torch.as_tensor(b0)
                scope._set(b_name, ((b0.reshape(-1) - mean) * inv_std
                                    + beta).to(b0.dtype).reshape(
                                        b0.shape))
                idx = graph.block.ops.index(bn)
                graph.remove_op(bn)
                if bn_out in graph.attrs.get("protected", ()):
                    graph.block.insert_op(idx, "assign", {"X": [mid]},
                                          {"Out": [bn_out]}, {})
                else:
                    graph.replace_input_everywhere(bn_out, mid)
            else:
                bias_name = w_name + "@bn_fused_bias"
                bias_val = (beta - mean * inv_std).to(w.dtype)
                scope.var(bias_name)
                scope._set(bias_name, bias_val)
                graph.block.create_var(name=bias_name,
                                       shape=list(bias_val.shape),
                                       dtype=bias_val.dtype,
                                       persistable=True)
                idx = graph.block.ops.index(bn)
                graph.remove_op(bn)
                graph.block.insert_op(
                    idx, "elementwise_add",
                    {"X": [conv_out], "Y": [bias_name]},
                    {"Out": [bn_out]}, {"axis": 1})


@register_pass("fc_fuse_pass")
class FCFusePass(Pass):
    """mul + elementwise_add (+ relu) -> fc op (reference
    ir/fc_fuse_pass.cc): one op for the interpreter to dispatch in
    place of three."""

    def apply_impl(self, graph: Graph, scope):
        protected = graph.attrs.get("protected", set())
        i = 0
        # single forward sweep (no restart after a fuse): fusing at
        # position i only touches ops up to the optional act right
        # after the add, so continuing from i stays correct and keeps
        # the pass O(n^2) instead of O(n^3) on big serving programs
        while i < len(graph.block.ops):
            add = graph.block.ops[i]
            i += 1
            if add.type != "elementwise_add":
                continue
            mul = graph.producer(add, "X")
            if mul is None or mul.type != "mul":
                continue
            # Y must be a 1-D persistable bias param (reference
            # fc_fuse_pass.cc checks the same) — a residual add of
            # an activation is NOT an fc bias
            y_name = add.input("Y")[0]
            y_var = (graph.block.vars.get(y_name)
                     or graph.block._find_var_recursive(y_name))
            if (y_var is None or not y_var.persistable
                    or y_var.shape is None or len(y_var.shape) != 1):
                continue
            if graph.producer(add, "Y") is not None:
                continue
            mul_out, = mul.output("Out")
            if mul_out in protected:
                continue
            if [c is add for c in
                    graph.consumers(mul, mul_out)] != [True]:
                continue
            add_out, = add.output("Out")
            act = None
            consumers = graph.consumers(add, add_out)
            if (len(consumers) == 1 and consumers[0].type == "relu"
                    and add_out not in protected):
                act = consumers[0]
            out_name = act.output("Out")[0] if act else add_out
            idx = graph.block.ops.index(mul)
            for dead in ([mul, add] + ([act] if act else [])):
                graph.remove_op(dead)
            graph.block.insert_op(
                idx, "fc",
                {"Input": mul.input("X"), "W": mul.input("Y"),
                 "Bias": add.input("Y")},
                {"Out": [out_name]},
                {"in_num_col_dims": mul.attr("x_num_col_dims", 1),
                 "activation_type": "relu" if act else ""})
            i = idx  # continue right after the new fc op


@register_pass("attention_fuse_pass")
class AttentionFusePass(Pass):
    """Fuse the hand-written scaled-dot-product attention composition
    (reference nets.py scaled_dot_product_attention builds it from
    matmul/scale/softmax/dropout/matmul -- the reference has NO fused
    attention op) into the framework's `attention` op, which routes to
    the attention kernels (ops/nn_ops.py).

    Pattern on 4D [B,H,T,D] operands:
        matmul(Q, K, transpose_Y=True) [-> scale] -> softmax
        [-> dropout] -> matmul(., V)
    Every intermediate must have exactly one consumer and not be
    protected (fetched).
    """

    def apply_impl(self, graph: Graph, scope):
        protected = graph.attrs.get("protected", set())

        def sole_consumer(op, out_name):
            if out_name in protected:
                return None
            cons = graph.consumers(op, out_name)
            return cons[0] if len(cons) == 1 else None

        i = 0
        while i < len(graph.block.ops):
            qk = graph.block.ops[i]
            i += 1
            if qk.type != "matmul" or not qk.attr("transpose_Y", False) \
                    or qk.attr("transpose_X", False):
                continue
            qv = graph.block._find_var_recursive(qk.input("X")[0])
            if qv is None or qv.shape is None or len(qv.shape) != 4:
                continue
            scale = qk.attr("alpha", 1.0)
            cur = qk
            out, = cur.output("Out")
            nxt = sole_consumer(cur, out)
            scale_op = None
            if nxt is not None and nxt.type == "scale":
                if nxt.attr("bias", 0.0) != 0.0:
                    continue
                scale_op = nxt
                scale *= nxt.attr("scale", 1.0)
                cur, out = nxt, nxt.output("Out")[0]
                nxt = sole_consumer(cur, out)
            if nxt is None or nxt.type != "softmax" or \
                    nxt.attr("axis", -1) not in (-1, 3):
                continue  # fused attention softmaxes the LAST axis
            sm = nxt
            cur, out = sm, sm.output("Out")[0]
            nxt = sole_consumer(cur, out)
            dropout_rate = 0.0
            drop = None
            if nxt is not None and nxt.type == "dropout":
                if nxt.attr("dropout_implementation",
                            "downgrade_in_infer") != "upscale_in_train":
                    continue  # infer-mode scaling changes semantics
                drop = nxt
                dropout_rate = (0.0 if drop.attr("is_test", False)
                                else drop.attr("dropout_prob", 0.5))
                cur, out = drop, drop.output("Out")[0]
                nxt = sole_consumer(cur, out)
            if nxt is None or nxt.type != "matmul" or \
                    nxt.attr("transpose_X", False) or \
                    nxt.attr("transpose_Y", False) or \
                    nxt.attr("alpha", 1.0) != 1.0 or \
                    nxt.input("X")[0] != out:
                continue
            pv = nxt
            final_out = pv.output("Out")[0]
            ops_to_remove = [op for op in (qk, scale_op, sm, drop, pv)
                             if op is not None]
            idx = graph.block.ops.index(qk)
            for dead in ops_to_remove:
                graph.remove_op(dead)
            graph.block.insert_op(
                idx, "attention",
                {"Q": qk.input("X"), "K": qk.input("Y"),
                 "V": pv.input("Y")},
                {"Out": [final_out]},
                {"scale": float(scale), "causal": False,
                 "dropout_rate": float(dropout_rate),
                 "layout": "bhtd"})
            i = idx + 1


@register_pass("identity_elimination_pass")
class IdentityEliminationPass(Pass):
    """Drop no-op ops: scale(scale=1, bias=0), cast to the same dtype,
    chained assign (reference: the simplification family of
    inference passes, e.g. identity_scale_op_clean_pass.cc)."""

    def apply_impl(self, graph: Graph, scope):
        protected = graph.attrs.get("protected", set())
        for op in list(graph.block.ops):
            out_name = None
            if op.type == "scale" and op.attr("scale", 1.0) == 1.0 \
                    and op.attr("bias", 0.0) == 0.0:
                out_name, = op.output("Out")
            elif op.type == "cast":
                src = graph.block._find_var_recursive(op.input("X")[0])
                if src is not None and src.dtype is not None and \
                        op.attr("out_dtype") in (src.dtype,
                                                 getattr(src.dtype,
                                                         "value", None)):
                    out_name, = op.output("Out")
            elif op.type == "assign":
                # collapse assigns only into pure temps (a persistable
                # target is a state write-back the executor threads)
                out_name, = op.output("Out")
                var = graph.block._find_var_recursive(out_name)
                if var is not None and var.persistable:
                    out_name = None
            if out_name is None or out_name in protected:
                continue
            x, = op.input("X")
            # rewiring readers of out_name to x is only sound if
            # NEITHER name is redefined later (an in-place write to x
            # would leak the new value into pre-write readers; a
            # rewrite of out_name would double-apply)
            idx = graph.block.ops.index(op)
            later_writes = {n for later in graph.block.ops[idx + 1:]
                            for n in later.output_arg_names}
            if x in later_writes or out_name in later_writes:
                continue
            graph.replace_input_everywhere(out_name, x, after=op)
            graph.remove_op(op)


@register_pass("conv_relu_fuse_pass")
class ConvReluFusePass(Pass):
    """conv2d [+ per-channel elementwise_add bias] + relu ->
    conv2d_fusion(activation=relu) (reference
    ir/conv_relu_mkldnn_fuse_pass.cc / conv_bias_mkldnn_fuse_pass.cc;
    the target is the JAX package's conv2d_fusion op, which the port
    does not run yet). The pass keeps the program-level rewrite the
    reference's inference pipeline exposes."""

    def apply_impl(self, graph: Graph, scope):
        protected = graph.attrs.get("protected", set())
        for relu in list(graph.block.ops):
            if relu.type != "relu":
                continue
            prev = graph.producer(relu, "X")
            add = None
            if (prev is not None and prev.type == "elementwise_add"
                    and prev.attr("axis", -1) == 1):
                # only a per-channel (1-D, length C) Y is a conv bias;
                # higher-rank Y uses fluid left-aligned broadcast the
                # fused kernel's (1,C,1,1) reshape would misapply
                y_var = graph.block._find_var_recursive(
                    prev.input("Y")[0])
                if y_var is not None and y_var.shape is not None \
                        and len(y_var.shape) == 1:
                    add = prev
                    prev = graph.producer(add, "X")
            if prev is None or prev.type != "conv2d":
                continue
            conv_out, = prev.output("Output")
            nxt = add if add is not None else relu
            if [c is nxt for c in graph.consumers(prev, conv_out)] \
                    != [True]:
                continue
            mid = add.output("Out")[0] if add is not None else conv_out
            if add is not None:
                if [c is relu for c in graph.consumers(add, mid)] \
                        != [True]:
                    continue
                if mid in protected:
                    continue
            if conv_out in protected:
                continue
            relu_out, = relu.output("Out")
            inputs = {"Input": prev.input("Input"),
                      "Filter": prev.input("Filter")}
            if add is not None:
                inputs["Bias"] = add.input("Y")
            idx = graph.block.ops.index(prev)
            graph.remove_op(prev)
            if add is not None:
                graph.remove_op(add)
            graph.remove_op(relu)
            graph.block.insert_op(
                idx, "conv2d_fusion", inputs, {"Output": [relu_out]},
                {**prev.attrs, "activation": "relu"})


@register_pass("conv_eltwiseadd_fuse_pass")
class ConvEltwiseAddFusePass(Pass):
    """conv2d + same-shape elementwise_add (residual) ->
    conv2d_fusion(ResidualData) (reference
    ir/conv_elementwise_add_fuse_pass.cc)."""

    def apply_impl(self, graph: Graph, scope):
        protected = graph.attrs.get("protected", set())
        for add in list(graph.block.ops):
            if add.type != "elementwise_add":
                continue
            if add.attr("axis", -1) not in (-1, 0):
                continue
            conv = graph.producer(add, "X")
            if conv is None or conv.type != "conv2d":
                continue
            # residual fusion is elementwise: Y must be full-rank
            # NCHW (fluid left-aligned broadcast of a lower-rank Y
            # is NOT what the fused kernel's plain add computes)
            y_var = graph.block._find_var_recursive(add.input("Y")[0])
            if y_var is None or y_var.shape is None \
                    or len(y_var.shape) != 4:
                continue
            conv_out, = conv.output("Output")
            if conv_out in protected:
                continue
            if [c is add for c in graph.consumers(conv, conv_out)] \
                    != [True]:
                continue
            add_out, = add.output("Out")
            idx = graph.block.ops.index(conv)
            graph.remove_op(conv)
            graph.remove_op(add)
            graph.block.insert_op(
                idx, "conv2d_fusion",
                {"Input": conv.input("Input"),
                 "Filter": conv.input("Filter"),
                 "ResidualData": add.input("Y")},
                {"Output": [add_out]},
                {**conv.attrs, "activation": "identity"})


class _FuseOptimizerBase(Pass):
    """Fuse N per-param optimizer ops into ONE update over coalesced
    buffers (reference details/fuse_optimizer_op_pass.cc +
    fuse_sgd_op_pass.cc / fuse_adam_op_pass.cc). Plan per group of
    fusable ops (same type, same attrs, same LearningRate):

        alloc_continuous_space per slot (Param, Grad, moments...) ->
        one optimizer op on the fused 1-D buffers ->
        slice+reshape the updated fused param (and moments) back to
        the ORIGINAL names, so the executor's state write-back is
        untouched.

    The pass keeps the reference's program-level rewrite, and the fused
    form is what fuse_all_reduce-style distributed rewrites key on."""

    op_type = None
    state_slots = ()     # per-param state to coalesce alongside Param
    scalar_slots = ()    # per-param [1]-shaped inputs equal across the
    # group (beta pows) -- the fused op reuses the first op's var

    def _fusable(self, ops):
        groups = {}
        for op in ops:
            if op.type != self.op_type:
                continue
            key = (tuple(sorted(op.attrs.items())),
                   tuple(op.input("LearningRate")))
            groups.setdefault(key, []).append(op)
        return [g for g in groups.values() if len(g) > 1]

    def apply_impl(self, graph: Graph, scope):
        from . import unique_name

        block = graph.block
        for group in self._fusable(list(block.ops)):
            first = group[0]
            idx = min(block.ops.index(op) for op in group)
            for op in group:
                block.ops.remove(op)
            new_ops = []

            def coalesce(slot):
                names = [op.input(slot)[0] for op in group]
                fused = unique_name.generate(f"fused_{slot.lower()}")
                view_names = [unique_name.generate(f"{n}@VIEW")
                              for n in names]
                block.create_var(name=fused)
                for v in view_names:
                    block.create_var(name=v)
                new_ops.append(Operator(
                    block, "alloc_continuous_space",
                    {"Input": names},
                    {"Output": view_names, "FusedOutput": [fused]}, {}))
                return names, fused

            slots = ("Param", "Grad") + tuple(self.state_slots)
            fused_names = {}
            orig_names = {}
            for slot in slots:
                orig_names[slot], fused_names[slot] = coalesce(slot)

            fused_out = {}
            op_inputs = {s: [fused_names[s]] for s in slots}
            op_inputs["LearningRate"] = first.input("LearningRate")
            for s in self.scalar_slots:
                op_inputs[s] = first.input(s)
            op_outputs = {}
            for s in ("Param",) + tuple(self.state_slots):
                fo = unique_name.generate(f"fused_{s.lower()}_out")
                block.create_var(name=fo)
                fused_out[s] = fo
                op_outputs[s + "Out"] = [fo]
            new_ops.append(Operator(block, self.op_type, op_inputs,
                                    op_outputs, dict(first.attrs)))
            # beta-pow style scalar state keeps advancing via explicit
            # scale ops (reference fuse_adam_op_pass.cc FuseScaleOps);
            # the fused op reads the first op's pows but updates none
            for slot in self.scalar_slots:
                factor = first.attrs.get(
                    {"Beta1Pow": "beta1", "Beta2Pow": "beta2"}.get(
                        slot, ""), None)
                if factor is None:
                    continue
                for op in group:
                    pow_name = op.input(slot)[0]
                    new_ops.append(Operator(
                        block, "scale", {"X": [pow_name]},
                        {"Out": [pow_name]},
                        {"scale": float(factor), "bias": 0.0}))

            # scatter updated fused buffers back to the original vars
            for s in ("Param",) + tuple(self.state_slots):
                off = 0
                for op, orig in zip(group, orig_names[s]):
                    var = block._find_var_recursive(orig)
                    shape = list(var.shape)
                    n = int(np.prod(shape)) if shape else 1
                    flat = unique_name.generate(f"{orig}@FLAT")
                    block.create_var(name=flat)
                    new_ops.append(Operator(
                        block, "slice", {"Input": [fused_out[s]]},
                        {"Out": [flat]},
                        {"axes": [0], "starts": [off],
                         "ends": [off + n]}))
                    new_ops.append(Operator(
                        block, "reshape", {"X": [flat]},
                        {"Out": [orig]}, {"shape": shape}))
                    off += n
            for i, nop in enumerate(new_ops):
                block.ops.insert(idx + i, nop)


@register_pass("fuse_sgd_op_pass")
class FuseSgdOpPass(_FuseOptimizerBase):
    """reference details/fuse_sgd_op_pass.cc."""

    op_type = "sgd"


@register_pass("fuse_adam_op_pass")
class FuseAdamOpPass(_FuseOptimizerBase):
    """reference details/fuse_adam_op_pass.cc. Beta pows are shared
    from the group's first op (they are numerically identical across
    params: same init, same step count -- the reference reaches the
    same state through FuseScaleOps)."""

    op_type = "adam"
    state_slots = ("Moment1", "Moment2")
    scalar_slots = ("Beta1Pow", "Beta2Pow")
