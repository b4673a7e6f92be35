"""Program-level reverse autodiff: append_backward (the port's copy of
``paddle_tpu/backward.py``; reference python/paddle/fluid/backward.py:394
append_backward, :135 _addup_repetitive_outputs_).

Walks the ops that produce the loss in reverse, asks each op's grad
maker (``core/registry.py``: the generic ``torch.func.vjp`` maker, or an
op's own) for grad ops, sums gradients that meet with ``sum`` ops (a var
read by N ops receives N partial grads), and passes ``@EMPTY@`` for an
output grad that backprop never produces; the grad kernels take zeros
there. With `checkpoints` (activation checkpointing, the JAX package's
``_recompute_plan`` / ``_emit_recompute``) the activations between two
checkpoints are recomputed by clones of their ops just before the grad
ops of that segment, so the Executor's last-use plan frees them in the
forward region: only the checkpoints stay live into the backward.
"""
from __future__ import annotations

from typing import Dict, Set

from . import unique_name
from .core.program import GRAD_SUFFIX, Operator, Variable, grad_var_name
from .core.registry import EMPTY_VAR, make_grad_ops

OP_ROLE_KEY = "op_role"


def _find_op_path(block, loss_name: str, stop_names: Set[str]):
    """Ops that (transitively) produce the loss (reference
    backward.py:573 _find_op_path_)."""
    needed = {loss_name}
    path = []
    for op in reversed(block.ops):
        if set(op.output_arg_names) & needed:
            path.append(op)
            for n in op.input_arg_names:
                if n not in stop_names and n != EMPTY_VAR:
                    needed.add(n)
    path.reverse()
    return path


def _collect_no_grad(block, extra=None) -> Set[str]:
    """Vars that take no gradient: stop_gradient ones (data vars by
    default) and integer or boolean ones."""
    no_grad = set(extra or ())
    for var in block.vars.values():
        if var.stop_gradient:
            no_grad.add(var.name)
        if var.dtype is not None and var.dtype.value.startswith(
                ("int", "uint", "bool")):
            no_grad.add(var.name)
    return no_grad


def _ensure_grad_var(block, fwd_name: str, grad_name: str):
    if grad_name in block.vars:
        return block.vars[grad_name]
    fwd = block._find_var_recursive(fwd_name)
    return block.create_var(
        name=grad_name,
        shape=fwd.shape if fwd is not None else None,
        dtype=fwd.dtype if fwd is not None else None,
        persistable=False)


def _recompute_plan(block, op_path, checkpoints, loss_name):
    """Segments of `op_path` (each ends at an op that writes a checkpoint;
    the ops after the last one form the tail) and the names that stay live
    from the forward into the backward: the checkpoints, the loss,
    persistables, feeds, and any value read outside the segment that
    writes it (a skip connection past a checkpoint), whose readers then
    read the original instead of chaining recomputes across segments
    (reference backward.py ``_recompute_plan``)."""
    ckpt = {c.name if hasattr(c, "name") else c for c in checkpoints}
    saved = set(ckpt) | {loss_name}
    saved.update(n for n, v in block.vars.items()
                 if v.persistable or v.is_data)
    segments, cur = [], []
    for op in op_path:
        cur.append(op)
        if any(o in ckpt for o in op.output_arg_names):
            segments.append(cur)
            cur = []
    if cur:
        segments.append(cur)
    producer_seg = {}
    for i, seg in enumerate(segments):
        for op in seg:
            for o in op.output_arg_names:
                producer_seg.setdefault(o, i)
    for i, seg in enumerate(segments):
        for op in seg:
            saved.update(n for n in op.input_arg_names
                         if producer_seg.get(n, i) != i)
    return segments, saved


def _emit_recompute(block, segment, saved, seg_idx):
    """Clones of `segment`'s ops that write its values not in `saved`
    again under ``@RECOMP<seg_idx>`` names, appended to `block`; returns
    {forward name: recomputed name}. A clone reads another clone's output
    where there is one, and a value from outside the recompute through an
    ``optimization_barrier`` op, as the JAX package emits them (there
    they keep XLA's CSE from merging the clones back into the forward;
    in the port they are the identity). A clone keeps its forward op's
    uid, so a sampling op (dropout, attention dropout) draws its
    forward's mask again: the same step key, uid and call index."""
    remap, barriered = {}, {}

    def barrier(name):
        if name not in barriered:
            bname = unique_name.generate(f"{name}@BAR{seg_idx}")
            block.ops.append(Operator(
                block, "optimization_barrier", {"X": [name]},
                {"Out": [bname]}, {OP_ROLE_KEY: "backward"}))
            _ensure_grad_var(block, name, bname)
            barriered[name] = bname
        return barriered[name]

    def source(name):
        if name in remap:
            return remap[name]
        return name if name == EMPTY_VAR else barrier(name)

    for op in segment:
        renames = {n: unique_name.generate(f"{n}@RECOMP{seg_idx}")
                   for n in op.output_arg_names if n not in saved}
        if not renames:
            continue
        clone = Operator(
            block, op.type,
            {slot: [source(n) for n in names]
             for slot, names in op.inputs.items()},
            {slot: [renames.get(n, n) for n in names]
             for slot, names in op.outputs.items()},
            dict(op.attrs))
        clone._uid = op._uid
        clone.attrs[OP_ROLE_KEY] = "backward"
        block.ops.append(clone)
        for orig, renamed in renames.items():
            _ensure_grad_var(block, orig, renamed)
            remap[orig] = renamed
    return remap


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append grad ops for `loss`; returns [(param, grad_var)] pairs.

    `callbacks`: each is called as ``cb(block, context)`` after every
    grad op is appended, `context` mapping each grad name to its forward
    name (Fluid's contract; the default, ``clip.error_clip_callback``,
    does nothing, as in the JAX package). `checkpoints`: forward
    variables (or names) to keep; the activations between two of them
    are recomputed in the backward region (``_recompute_plan``)."""
    block = loss.block
    program = block.program
    no_grad = _collect_no_grad(block, no_grad_set)
    op_path = _find_op_path(block, loss.name, no_grad)

    # seed: d loss / d loss = 1
    loss_grad = grad_var_name(loss.name)
    _ensure_grad_var(block, loss.name, loss_grad)
    block.ops.append(Operator(
        block, "fill_any_like", {"X": [loss.name]}, {"Out": [loss_grad]},
        {"value": 1.0, OP_ROLE_KEY: "backward"}))
    produced: Set[str] = {loss_grad}
    if checkpoints:
        segments, saved = _recompute_plan(block, op_path, checkpoints,
                                          loss.name)
    else:
        segments, saved = [op_path], None
    grad_to_var: Dict[str, str] = {}
    # the tail (the ops after the last checkpoint: the loss head) is
    # recomputed too, as in the JAX package
    for seg_idx in range(len(segments) - 1, -1, -1):
        remap = ({} if saved is None else
                 _emit_recompute(block, segments[seg_idx], saved, seg_idx))
        _backward_over(segments[seg_idx], block, no_grad, produced, remap,
                       callbacks or (), grad_to_var)
    # the grad ops went into block.ops directly, not through insert_op
    program._version += 1

    if parameter_list is not None:
        params = [p if isinstance(p, Variable)
                  else program.global_block.var(p) for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    return [(p, block.vars[grad_var_name(p.name)]) for p in params
            if grad_var_name(p.name) in produced]


def _backward_over(ops, block, no_grad, produced, remap, callbacks,
                   grad_to_var):
    """Emit grad ops for `ops` reversed (reference backward.py:252);
    `remap` sends their reads of forward activations to the recomputed
    clones (empty without checkpoints)."""
    for op in reversed(ops):
        for gop in make_grad_ops(op, no_grad_set=no_grad):
            gop.attrs.setdefault(OP_ROLE_KEY, "backward")
            for slot, names in gop.inputs.items():
                if slot.endswith(GRAD_SUFFIX):
                    gop.inputs[slot] = [n if n in produced else EMPTY_VAR
                                        for n in names]
                elif remap:
                    gop.inputs[slot] = [remap.get(n, n) for n in names]
            # a grad already produced gets a renamed partial, summed in
            renames = []
            for slot, names in gop.outputs.items():
                new_names = []
                for n in names:
                    if n in produced:
                        tmp = unique_name.generate(n + "@RENAME")
                        renames.append((n, tmp))
                        new_names.append(tmp)
                    else:
                        new_names.append(n)
                gop.outputs[slot] = new_names
            block.ops.append(gop)
            for slot, names in gop.outputs.items():
                fwd_slot = slot[:-len(GRAD_SUFFIX)]
                fwd_names = (op.inputs.get(fwd_slot, [])
                             if gop.type.endswith("_grad") else [])
                for i, n in enumerate(names):
                    src = fwd_names[i] if i < len(fwd_names) else None
                    _ensure_grad_var(block, src or n, n)
                    produced.add(n)
                    if src is not None:
                        grad_to_var[n] = src
            for cb in callbacks:
                cb(block, grad_to_var)
            for orig, tmp in renames:
                block.ops.append(Operator(
                    block, "sum", {"X": [orig, tmp]}, {"Out": [orig]},
                    {OP_ROLE_KEY: "backward"}))
                produced.add(orig)
