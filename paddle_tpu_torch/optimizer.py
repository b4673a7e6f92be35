"""Optimizers (reference python/paddle/fluid/optimizer.py; the port's
subset of paddle_tpu/optimizer.py: the Optimizer pipeline, SGD, Momentum,
LarsMomentum, Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp,
Ftrl and RecomputeOptimizer).

minimize() = append_backward + gradient clipping + regularization + one
optimizer op per parameter + the optimizer's `_finish_update` ops, the
reference's pipeline (optimizer.py:424, 303, 361, 212). The optimizer ops
name each parameter and accumulator as both input and output, so the
Executor commits their new values to the scope.
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

__all__ = ["SGD", "Momentum", "Adagrad", "Adam", "Adamax",
           "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl",
           "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer",
           "AdamOptimizer", "AdamaxOptimizer",
           "DecayedAdagradOptimizer", "AdadeltaOptimizer",
           "RMSPropOptimizer", "FtrlOptimizer", "LarsMomentum",
           "LarsMomentumOptimizer", "RecomputeOptimizer", "Optimizer"]


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

    def _finish_update(self, block, parameters_and_grads):
        """Ops appended once after every parameter's update (Adamax
        advances its beta1 powers here)."""

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
        ops = [self._append_optimize_op(block, pg)
               for pg in parameters_and_grads
               if pg[1] is not None and pg[0].trainable]
        self._finish_update(block, parameters_and_grads)
        return ops

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


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            {"Param": p, "Grad": g, "Velocity": v,
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": p, "VelocityOut": v},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov,
             "op_role": "optimize"})


class LarsMomentumOptimizer(Optimizer):
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            {"Param": p, "Grad": g, "Velocity": v,
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": p, "VelocityOut": v},
            {"mu": self._momentum, "lars_coeff": self._lars_coeff,
             "lars_weight_decay": self._lars_weight_decay,
             "op_role": "optimize"})


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            {"Param": p, "Grad": g, "Moment": m,
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": p, "MomentOut": m},
            {"epsilon": self._epsilon, "op_role": "optimize"})


class AdamOptimizer(Optimizer):
    """Adam (reference optimizer.py AdamOptimizer): per parameter two
    moments and two beta-power accumulators, advanced by the adam op.
    `lazy_mode` is taken and changes nothing, as in the JAX package: the
    update is the dense one, since a grad here is always a dense tensor
    (the reference's lazy mode updates only the rows of a sparse one)."""

    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
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


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        return block.append_op(
            "adamax",
            {"Param": p, "Grad": g, "Moment": m, "InfNorm": inf,
             "Beta1Pow": self._get_accumulator("beta1_pow_acc", p),
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": p, "MomentOut": m, "InfNormOut": inf},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon, "op_role": "optimize"})

    def _finish_update(self, block, parameters_and_grads):
        """beta1^t -> beta1^(t+1) for each updated parameter, after all
        the updates of the step have read it."""
        for p, g in parameters_and_grads:
            if g is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op("scale", {"X": b1p}, {"Out": b1p},
                            {"scale": self._beta1, "op_role": "optimize"})


class DecayedAdagradOptimizer(Optimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            {"Param": p, "Grad": g, "Moment": m,
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": p, "MomentOut": m},
            {"decay": self._decay, "epsilon": self._epsilon,
             "op_role": "optimize"})


class AdadeltaOptimizer(Optimizer):
    """Adadelta: its op takes no learning rate (adadelta_op.cc); the
    `learning_rate` given is kept, as the reference keeps it."""

    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            {"Param": p, "Grad": g, "AvgSquaredGrad": asg,
             "AvgSquaredUpdate": asu},
            {"ParamOut": p, "AvgSquaredGradOut": asg,
             "AvgSquaredUpdateOut": asu},
            {"epsilon": self._epsilon, "rho": self._rho,
             "op_role": "optimize"})


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        return block.append_op(
            "rmsprop",
            {"Param": p, "Grad": g, "Moment": mom, "MeanSquare": ms,
             "MeanGrad": mg,
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": p, "MomentOut": mom, "MeanSquareOut": ms,
             "MeanGradOut": mg},
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum, "centered": self._centered,
             "op_role": "optimize"})


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            {"Param": p, "Grad": g, "SquaredAccumulator": sq,
             "LinearAccumulator": lin,
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": p, "SquaredAccumOut": sq, "LinearAccumOut": lin},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power,
             "op_role": "optimize"})


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
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
