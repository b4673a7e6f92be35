"""Optimizers (reference python/paddle/fluid/optimizer.py; the port's
subset of paddle_tpu/optimizer.py: the Optimizer pipeline, SGD, Momentum,
DGCMomentum, LarsMomentum, Adagrad, Adam, Adamax, DecayedAdagrad,
Adadelta, RMSProp, Ftrl, RecomputeOptimizer and GradientMergeOptimizer,
and the parameter averages ModelAverage and ExponentialMovingAverage).

minimize() = append_backward + gradient clipping + regularization + one
optimizer op per parameter + the optimizer's `_finish_update` ops, the
reference's pipeline (optimizer.py:424, 303, 361, 212). The optimizer ops
name each parameter and accumulator as both input and output, so the
Executor commits their new values to the scope.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .core.program import Variable, default_main_program
from .core.scope import global_scope
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["SGD", "Momentum", "Adagrad", "Adam", "Adamax",
           "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl",
           "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer",
           "AdamOptimizer", "AdamaxOptimizer",
           "DecayedAdagradOptimizer", "AdadeltaOptimizer",
           "RMSPropOptimizer", "FtrlOptimizer", "LarsMomentum",
           "LarsMomentumOptimizer", "RecomputeOptimizer", "Optimizer",
           "DGCMomentumOptimizer", "GradientMergeOptimizer",
           "ModelAverage", "ExponentialMovingAverage"]


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


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep Gradient Compression momentum (reference optimizer.py:589):
    per parameter a velocity U and a residual V for the ``dgc_momentum``
    op (momentum correction, residual accumulation, selection by the
    sparsity's quantile under the rampup schedule, momentum factor
    masking; ``parallel.dgc``), one step counter shared by all, advanced
    after the updates. Before rampup_begin_step the op is the momentum
    op. `local_grad_clip_norm` clips each gradient first. The collective
    form of the JAX package (``dgc_allreduce_step``) is not ported
    yet."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None, **kwargs):
        super().__init__(learning_rate, momentum, use_nesterov, **kwargs)
        self._sparsity = list(sparsity)
        self._rampup_begin_step = rampup_begin_step
        self._rampup_step = rampup_step
        self._local_grad_clip_norm = local_grad_clip_norm
        self._step_var = None

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)
        if self._step_var is None:
            helper = LayerHelper("dgc_step")
            self._step_var = helper.create_global_variable(
                [1], "float32", persistable=True,
                name=unique_name.generate("dgc_counter"))
            helper.set_variable_initializer(self._step_var,
                                            ConstantInitializer(0.0))

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        if self._local_grad_clip_norm is not None:
            from . import layers

            g = layers.clip_by_norm(g, self._local_grad_clip_norm)
        return block.append_op(
            "dgc_momentum",
            {"Param": p, "Grad": g, "U": self._get_accumulator("dgc_u", p),
             "V": self._get_accumulator("dgc_v", p),
             "CurrentStep": self._step_var,
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": p, "UOut": self._get_accumulator("dgc_u", p),
             "VOut": self._get_accumulator("dgc_v", p)},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov,
             "sparsity": self._sparsity,
             "rampup_begin_step": self._rampup_begin_step,
             "rampup_step": self._rampup_step, "op_role": "optimize"})

    def _finish_update(self, block, parameters_and_grads):
        block.append_op("increment", {"X": self._step_var},
                        {"Out": self._step_var},
                        {"step": 1.0, "op_role": "optimize"})


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


class GradientMergeOptimizer(Optimizer):
    """Gradient accumulation: each step adds its gradients into
    persistable accumulators; every k_steps-th step the inner optimizer
    applies their mean (`avg`) or sum, then the accumulators clear
    (reference ir/multi_batch_merge_pass.cc; paddle_tpu/optimizer.py:537).
    The optimize section is a ``run_block_if`` gated on the step count,
    so one program runs every micro-step, the inner optimizer's state
    (moments, step counters) moves only on the steps that apply, and the
    step stays capturable in a CUDA graph."""

    def __init__(self, inner_optimizer, k_steps, avg=True):
        if k_steps < 1:
            raise ValueError("k_steps must be >= 1")
        super().__init__(0.0)
        self._inner = inner_optimizer
        self._k = int(k_steps)
        self._avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from . import layers
        from .layers.control_flow import _block_io_analysis

        prog = default_main_program()
        block = prog.global_block
        params_grads = self._inner.backward(
            loss, startup_program, parameter_list, no_grad_set)
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        helper = LayerHelper("gradient_merge")
        accs = {}
        for p, g in params_grads:
            if g is None:
                continue
            acc = helper.create_global_variable(
                list(p.shape), p.dtype, persistable=True,
                name=unique_name.generate(p.name + "@GRAD@MERGE"))
            helper.set_variable_initializer(acc, ConstantInitializer(0.0))
            block.append_op("elementwise_add", {"X": acc, "Y": g},
                            {"Out": acc}, {"op_role": "optimize"})
            accs[p.name] = acc
        step_var = helper.create_global_variable(
            [1], "float32", persistable=True,
            name=unique_name.generate("gmerge_step"))
        helper.set_variable_initializer(step_var, ConstantInitializer(0.0))
        block.append_op("increment", {"X": step_var}, {"Out": step_var},
                        {"step": 1.0, "op_role": "optimize"})
        pred = layers.equal(
            layers.elementwise_mod(
                step_var, layers.fill_constant([1], "float32",
                                               float(self._k))),
            layers.fill_constant([1], "float32", 0.0))
        # the rate must exist before the sub-block reads it
        self._inner._create_global_learning_rate()

        sub = prog.create_block()
        merged = []
        for p, g in params_grads:
            if g is None:
                continue
            mg = accs[p.name]
            if self._avg:
                mg = layers.scale(mg, scale=1.0 / self._k)
            merged.append((p, mg))
        merged = append_gradient_clip_ops(merged)
        merged = append_regularization_ops(merged,
                                           self._inner.regularization)
        self._inner._create_accumulators(
            sub, [p for p, g in merged if g is not None])
        optimize_ops = [self._inner._append_optimize_op(sub, pg)
                        for pg in merged
                        if pg[1] is not None and pg[0].trainable]
        self._inner._finish_update(sub, merged)
        for acc in accs.values():
            sub.append_op("scale", {"X": acc}, {"Out": acc},
                          {"scale": 0.0, "op_role": "optimize"})
        prog.rollback()
        parent = prog.current_block()
        carried, externals = _block_io_analysis(sub, parent)
        parent.append_op(
            "run_block_if",
            {"Condition": pred.name, "X": externals, "Init": carried},
            {"Out": carried},
            {"sub_block": sub, "carried": carried,
             "externals": externals, "op_role": "optimize"})
        return optimize_ops, params_grads


def _scope_swap(scope, values, need_restore):
    """A context manager that puts `values` ({param name: tensor}) into
    `scope` (default: the global scope) and, with `need_restore`, puts the
    old values back on exit."""

    @contextlib.contextmanager
    def guard():
        sc = scope or global_scope()
        backups = {n: sc._get(n) for n in values}
        for n, v in values.items():
            sc._set(n, v)
        try:
            yield
        finally:
            if need_restore:
                for n, v in backups.items():
                    sc._set(n, v)

    return guard()


class ModelAverage(Optimizer):
    """The running sum of each parameter and the count of steps summed,
    advanced every step (reference optimizer.py:1789; the JAX package's
    plain form: one window, no rotation). ``apply()`` swaps the averages
    into the scope for evaluation, and puts the parameters back on exit
    (`need_restore`); a parameter with nothing summed yet keeps its
    value."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        program = default_main_program()
        block = program.global_block
        for param in program.all_parameters():
            if param.do_model_average is not False:
                self._append_average_accumulate_op(block, param)

    def _append_average_accumulate_op(self, block, param):
        sum_1 = self._add_accumulator("sum_1", param)
        num_acc = self._add_accumulator("num_accumulates", param,
                                        shape=[1])
        block.append_op("sum", {"X": [sum_1, param]}, {"Out": sum_1},
                        {"op_role": "optimize"})
        block.append_op("increment", {"X": num_acc}, {"Out": num_acc},
                        {"step": 1.0, "op_role": "optimize"})

    def apply(self, executor=None, need_restore=True, scope=None):
        sc = scope or global_scope()
        values = {}
        for pname, sum_var in self._accumulators["sum_1"].items():
            n = sc._get(self._accumulators["num_accumulates"][pname].name)
            if float(n.reshape(-1)[0]) > 0:
                values[pname] = sc._get(sum_var.name) / n.reshape(())
        return _scope_swap(sc, values, need_restore)

    def restore(self, executor=None):
        pass


class ExponentialMovingAverage:
    """The exponential moving average of each trainable parameter,
    ema = decay * ema + (1 - decay) * param after every step, from 0 (no
    bias correction, as in the JAX package). ``apply()`` swaps the
    averages into the scope, and puts the parameters back on exit
    (`need_restore`)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        from . import layers

        self._decay = decay
        self._name = name or ""
        self._ema_vars = {}
        program = default_main_program()
        block = program.global_block
        helper = LayerHelper("ema")
        for param in program.all_parameters():
            if not param.trainable:
                continue
            ema = helper.create_global_variable(
                list(param.shape), param.dtype, persistable=True,
                name=unique_name.generate(param.name + ".ema"))
            helper.set_variable_initializer(ema, ConstantInitializer(0.0))
            self._ema_vars[param.name] = ema
            scaled_e = layers.scale(ema, scale=self._decay)
            scaled_p = layers.scale(param, scale=1.0 - self._decay)
            block.append_op("elementwise_add",
                            {"X": scaled_e, "Y": scaled_p}, {"Out": ema},
                            {"op_role": "optimize"})

    def update(self):
        pass

    def apply(self, executor=None, need_restore=True, scope=None):
        sc = scope or global_scope()
        values = {p: sc._get(e.name) for p, e in self._ema_vars.items()
                  if sc._get(e.name) is not None}
        return _scope_swap(sc, values, need_restore)

    def restore(self, executor=None):
        pass


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
