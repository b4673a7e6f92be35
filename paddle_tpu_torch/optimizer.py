"""Optimizers (reference python/paddle/fluid/optimizer.py; the port's
subset of paddle_tpu/optimizer.py: the Optimizer pipeline, SGD, Adam and
RecomputeOptimizer).

minimize() = append_backward + gradient clipping + regularization + one
optimizer op per parameter, the reference's pipeline (optimizer.py:424,
303, 361, 212). The optimizer ops name each parameter and accumulator as
both input and output, so the Executor commits their new values to the
scope.
"""
from __future__ import annotations

from collections import defaultdict

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .core.program import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["SGD", "Adam", "SGDOptimizer", "AdamOptimizer",
           "RecomputeOptimizer", "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators = defaultdict(dict)
        self._learning_rate_map = {}

    # --- learning rate ----------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if program in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        helper = LayerHelper("learning_rate")
        lr = helper.create_global_variable(
            [1], "float32", persistable=True,
            name=unique_name.generate("learning_rate"))
        helper.set_variable_initializer(
            lr, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[program] = lr

    def _global_learning_rate(self, program=None):
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        base = self._global_learning_rate()
        param_lr = getattr(param, "optimize_attr",
                           {"learning_rate": 1.0})["learning_rate"]
        if param_lr == 1.0:
            return base
        from . import layers

        return layers.scale(base, scale=float(param_lr))

    # --- accumulators -----------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            shape or list(param.shape), dtype or param.dtype,
            persistable=True,
            name=unique_name.generate(f"{param.name}_{name}"))
        helper.set_variable_initializer(var, ConstantInitializer(fill_value))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # --- pipeline (reference optimizer.py:424 minimize) -------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set,
                               callbacks or [error_clip_callback])

    def apply_gradients(self, params_grads):
        """Clip, then regularize, then one optimizer op per pair."""
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self._create_optimization_pass(params_grads)

    def _create_optimization_pass(self, parameters_and_grads):
        block = default_main_program().global_block
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        return [self._append_optimize_op(block, pg)
                for pg in parameters_and_grads
                if pg[1] is not None and pg[0].trainable]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            {"Param": p, "Grad": g,
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": p}, {"op_role": "optimize"})


class AdamOptimizer(Optimizer):
    """Adam (reference optimizer.py AdamOptimizer): per parameter two
    moments and two beta-power accumulators, advanced by the adam op."""

    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        if lazy_mode:
            raise NotImplementedError("Adam(lazy_mode=True) is not ported "
                                      "yet")
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)
            self._add_accumulator("beta2_pow_acc", p, shape=[1],
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            "adam",
            {"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
             "Beta1Pow": b1p, "Beta2Pow": b2p,
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
             "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon, "op_role": "optimize"})


class RecomputeOptimizer(Optimizer):
    """Activation checkpointing around another optimizer (``paddle_tpu``
    optimizer.py RecomputeOptimizer): only the checkpoints given to
    ``_set_checkpoints`` stay live from the forward into the backward;
    the activations between them are recomputed in the backward region
    (``backward._recompute_plan``). The inner optimizer clips,
    regularizes and updates.

        opt = RecomputeOptimizer(Adam(1e-3))
        opt._set_checkpoints([layer1_out, layer2_out])
        opt.minimize(loss)
    """

    def __init__(self, inner_optimizer):
        # before super(): __getattr__ must never recurse on a half-built
        # instance
        self.__dict__["_inner"] = inner_optimizer
        super().__init__(learning_rate=inner_optimizer._learning_rate,
                         regularization=inner_optimizer.regularization)
        self._checkpoints = None

    def __getattr__(self, name):
        # the wrapped optimizer's interface: accumulators, type, ...
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        if not self._checkpoints:
            raise ValueError(
                "RecomputeOptimizer: call _set_checkpoints([...]) with the "
                "activations to keep before minimize()")
        return append_backward(loss, parameter_list, no_grad_set,
                               callbacks or [error_clip_callback],
                               checkpoints=self._checkpoints)

    def apply_gradients(self, params_grads):
        return self._inner.apply_gradients(params_grads)


# fluid exposes both Foo and FooOptimizer names
SGD = SGDOptimizer
Adam = AdamOptimizer
