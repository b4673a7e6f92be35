"""LayerHelper: the layer-construction workhorse (reference
python/paddle/fluid/layer_helper.py; the port's copy of
paddle_tpu/layer_helper.py without the dygraph branches).

Creates parameters in BOTH the main program (metadata) and the startup
program (with their init op), creates temp output vars, and appends
ops.
"""
from __future__ import annotations

from . import unique_name
from .core.program import default_main_program, default_startup_program
from .core.types import as_datatype
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        name = attr.name or unique_name.generate(
            f"{self.name}.{'b' if is_bias else 'w'}")
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer())
        dtype = as_datatype(dtype)
        shape = [int(s) for s in shape]
        param = self.main_program.global_block.create_parameter(
            name=name, shape=shape, dtype=dtype,
            trainable=attr.trainable, regularizer=attr.regularizer,
            error_clip=attr.gradient_clip,
            do_model_average=attr.do_model_average)
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        sblock = self.startup_program.global_block
        svar = sblock.create_var(name=name, shape=shape, dtype=dtype,
                                 persistable=True)
        init(svar, sblock)
        return param

    def create_variable_for_type_inference(self, dtype=None,
                                           stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=as_datatype(dtype) if dtype else None,
            stop_gradient=stop_gradient)

    def create_global_variable(self, shape, dtype, persistable=False,
                               name=None, stop_gradient=True):
        return self.main_program.global_block.create_var(
            name=name or unique_name.generate(f"{self.name}.global"),
            shape=shape, dtype=as_datatype(dtype), persistable=persistable,
            stop_gradient=stop_gradient)

    def set_variable_initializer(self, var, initializer):
        """Append `var`'s init op to the startup program."""
        sblock = self.startup_program.global_block
        svar = sblock.create_var(name=var.name, shape=var.shape,
                                 dtype=var.dtype, persistable=True)
        initializer(svar, sblock)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.block.append_op(type, inputs, outputs, attrs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None:
            return input_var
        size = input_var.shape[dim_start:dim_end or len(input_var.shape)]
        b = self.create_parameter(bias_attr, list(size), input_var.dtype,
                                  is_bias=True)
        if b is None:
            return input_var
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op("elementwise_add", {"X": input_var, "Y": b},
                       {"Out": out}, {"axis": dim_start})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(act, {"X": input_var}, {"Out": out}, {})
        return out
