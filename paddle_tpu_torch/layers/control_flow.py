"""Control-flow layers (reference python/paddle/fluid/layers/control_flow.py;
the serving slice's subset of paddle_tpu/layers/control_flow.py).

``While`` carries a sub-Block; the ``while`` op interprets it in a
Python loop. The loop-carried state is every parent-visible var the
body writes.
"""
from __future__ import annotations

from ..core.program import default_main_program
from ..layer_helper import LayerHelper

__all__ = ["less_than", "greater_than", "equal", "less_than_value",
           "increment", "While"]


def _cmp_layer(op_type):
    def layer(x, y, cond=None):
        helper = LayerHelper(op_type, input=x)
        out = cond or helper.create_variable_for_type_inference(
            "bool", True)
        helper.append_op(op_type, {"X": x, "Y": y}, {"Out": out}, {})
        return out

    layer.__name__ = op_type
    return layer


less_than = _cmp_layer("less_than")
greater_than = _cmp_layer("greater_than")
equal = _cmp_layer("equal")


def less_than_value(x, value: float):
    """x < value, the value a float32 [1] constant."""
    from . import tensor

    return less_than(x, tensor.fill_constant([1], "float32", value))


def increment(x, value=1.0, in_place=True):
    from . import nn

    return nn.increment(x, value, in_place)


def _block_io_analysis(sub, parent):
    """(carried, externals) of sub-block `sub`: the parent-visible vars
    it writes, and the parent-visible vars it reads before writing that
    are not carried."""
    reads, writes = set(), set()
    for op in sub.ops:
        for n in op.input_arg_names:
            if n not in writes and parent._find_var_recursive(n) \
                    is not None:
                reads.add(n)
        writes.update(op.output_arg_names)
    carried = sorted(n for n in writes if n not in sub.vars
                     and parent._find_var_recursive(n) is not None)
    return carried, sorted(reads - set(carried))


class While:
    """reference layers/control_flow.py:492 While."""

    def __init__(self, cond, is_test=False, name=None):
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)
        self._program = default_main_program()

    def block(self):
        return _WhileBlockGuard(self)


class _WhileBlockGuard:
    def __init__(self, while_op: While):
        self.w = while_op

    def __enter__(self):
        self.block = self.w._program.create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            self.w._program.rollback()
            return False
        prog = self.w._program
        sub = prog.current_block()
        prog.rollback()
        parent = prog.current_block()
        carried, externals = _block_io_analysis(sub, parent)
        cond_name = self.w.cond_var.name
        if not any(cond_name in op.output_arg_names for op in sub.ops):
            raise ValueError(
                "While: the loop body never writes the condition var "
                f"{cond_name!r} -- the loop would spin forever. Update "
                "it inside the block, e.g. "
                "layers.less_than(i, limit, cond=cond).")
        parent.append_op(
            "while",
            {"Condition": self.w.cond_var.name, "X": externals,
             "Init": carried},
            {"Out": carried},
            {"sub_block": sub, "carried": carried,
             "externals": externals})
        return False
