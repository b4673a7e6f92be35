"""Program-level reverse autodiff: append_backward (the port's copy of
``paddle_tpu/backward.py``; reference python/paddle/fluid/backward.py:394
append_backward, :135 _addup_repetitive_outputs_).

Walks the ops that produce the loss in reverse, asks each op's grad
maker (``core/registry.py``: the generic ``torch.func.vjp`` maker, or an
op's own) for grad ops, sums gradients that meet with ``sum`` ops (a var
read by N ops receives N partial grads), and passes ``@EMPTY@`` for an
output grad that backprop never produces; the grad kernels take zeros
there. The recompute (activation checkpointing) path of the JAX
package is not ported yet.
"""
from __future__ import annotations

from typing import Set

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


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append grad ops for `loss`; returns [(param, grad_var)] pairs."""
    if callbacks:
        raise NotImplementedError(
            "append_backward: error-clip callbacks are not ported yet")
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
    _backward_over(op_path, block, no_grad, produced)
    # the grad ops went into block.ops directly, not through insert_op
    program._version += 1

    if parameter_list is not None:
        params = [p if isinstance(p, Variable)
                  else program.global_block.var(p) for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    return [(p, block.vars[grad_var_name(p.name)]) for p in params
            if grad_var_name(p.name) in produced]


def _backward_over(ops, block, no_grad, produced):
    """Emit grad ops for `ops` reversed (reference backward.py:252)."""
    for op in reversed(ops):
        for gop in make_grad_ops(op, no_grad_set=no_grad):
            gop.attrs.setdefault(OP_ROLE_KEY, "backward")
            for slot, names in gop.inputs.items():
                if slot.endswith(GRAD_SUFFIX):
                    gop.inputs[slot] = [n if n in produced else EMPTY_VAR
                                        for n in names]
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
            for orig, tmp in renames:
                block.ops.append(Operator(
                    block, "sum", {"X": [orig, tmp]}, {"Out": [orig]},
                    {OP_ROLE_KEY: "backward"}))
                produced.add(orig)
