"""The port's OpTest: one op of ``paddle_tpu_torch`` held against the
JAX package's op of the same type, and its grad op against central
differences (counterpart of the reference's
python/paddle/fluid/tests/unittests/op_test.py; the JAX package's own
harness, tests/op_test.py, does not import on this JAX and stays as it
is).

A case is a subclass that declares the op and its numpy operands:

    class TestExp(TorchOpTest):
        op_type = "exp"
        inputs = {"X": x}            # slot -> array, or list of arrays
        attrs = {}
        outputs = ["Out"]            # the output slots to compare

        def test_output(self):
            self.check_output()

        def test_grad(self):
            self.check_grad(["X"])

`check_output` runs the op through both registries on the CPU, one op
alone (``run_op``), and compares each output slot: the dtype, the shape,
NaN in the same places, and values within `rtol` + `atol`.
`port_outputs(device="cuda")` runs the port's op on the card, for the
cases that hold it against the CPU there; the JAX package is imported
only by the checks that read it, as the card's machine has none.
`check_grad` takes L = sum(w * Out) with w a fixed random weight, runs
the port's grad op (``make_grad_ops``) on the float32 inputs, and
compares each named input's gradient with float64 central differences
of L through the port's forward kernel, within `max_relative_error` of
max(|numeric|, 1) per element. `check_grad_with_reference` compares the
port's grad op with the JAX package's instead: for points where
differences mean nothing (a power at base 0).
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core import program as p_program
from paddle_tpu_torch.core import registry as p_registry


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _names(slot, vals):
    return [f"{slot}.{i}" for i in range(len(vals))]


def op_case(op_type, inputs, attrs=None, outputs=("Out",)):
    """A TorchOpTest of `op_type` on `inputs` ({slot: array}), built in
    place of a subclass: for parametrized cases."""
    t = TorchOpTest()
    t.op_type, t.inputs = op_type, inputs
    t.attrs, t.outputs = dict(attrs or {}), list(outputs)
    return t


class TorchOpTest:
    op_type: str = ""
    inputs: dict = {}
    attrs: dict = {}
    outputs: list = ["Out"]
    # a hook for planted faults: maps (slot, grad array) -> grad array
    grad_fault = None

    # --- building one op in either package ------------------------------
    def _op(self, program_mod):
        block = program_mod.Program().global_block
        ins = {s: _names(s, _as_list(v)) for s, v in self.inputs.items()}
        outs = {s: [f"{s}.out"] for s in self.outputs}
        return program_mod.Operator(block, self.op_type, ins, outs,
                                    dict(self.attrs))

    def _env(self, convert):
        env = {}
        for s, v in self.inputs.items():
            for n, a in zip(_names(s, _as_list(v)), _as_list(v)):
                env[n] = convert(np.asarray(a))
        return env

    def port_outputs(self, dtype=None, device="cpu"):
        """{slot: tensor} of the port's op on the inputs (cast to `dtype`
        where floating, if given) on `device` (the card: its kernels)."""
        op = self._op(p_program)
        device = torch.device(device)

        def conv(a):
            t = torch.from_numpy(a.copy())
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            return t.to(device)

        env = self._env(conv)
        p_registry.run_op(op, env, device)
        return {s: env[f"{s}.out"] for s in self.outputs
                if f"{s}.out" in env}

    def reference_outputs(self):
        """{slot: numpy array} of the JAX package's op on the inputs."""
        import jax.numpy as jnp

        from paddle_tpu.core import program as j_program
        from paddle_tpu.core import registry as j_registry

        op = self._op(j_program)
        env = self._env(jnp.asarray)
        j_registry.run_op(op, env)
        return {s: np.asarray(env[f"{s}.out"]) for s in self.outputs
                if f"{s}.out" in env}

    # --- checks ------------------------------------------------------------
    def check_output(self, rtol=1e-6, atol=1e-6, exact=False):
        """Every output slot of both packages: the same set of slots, the
        same dtype and shape, NaN in the same places, the values within
        rtol/atol (`exact`: the same values, -0.0 apart from 0.0)."""
        got = {s: t.numpy() for s, t in self.port_outputs().items()}
        want = self.reference_outputs()
        assert set(got) == set(want), (sorted(got), sorted(want))
        for s in want:
            g, w = got[s], want[s]
            assert g.dtype == w.dtype, (self.op_type, s, g.dtype, w.dtype)
            assert g.shape == w.shape, (self.op_type, s, g.shape, w.shape)
            if exact:
                np.testing.assert_array_equal(
                    g.view(np.uint8), w.view(np.uint8),
                    err_msg=f"{self.op_type} {s}: bits")
            else:
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                           equal_nan=True,
                                           err_msg=f"{self.op_type} {s}")
        return got

    def _weights(self, out):
        rs = np.random.RandomState(1234)
        return {s: torch.from_numpy(rs.uniform(0.5, 1.5, v.shape))
                for s, v in out.items() if v.is_floating_point()}

    def port_grads(self, inputs_to_check, weights):
        """The port's grad op on the float32 inputs with Out@GRAD = w:
        {slot: [grad arrays]}."""
        fwd = self._op(p_program)
        env = self._env(torch.from_numpy)
        for s, w in weights.items():
            env[p_program.grad_var_name(f"{s}.out")] = w.to(torch.float32)
        names = {}
        for op in p_registry.make_grad_ops(fwd):
            p_registry.run_op(op, env, torch.device("cpu"))
        for s in inputs_to_check:
            names[s] = [env[p_program.grad_var_name(n)].numpy()
                        for n in _names(s, _as_list(self.inputs[s]))]
            if self.grad_fault is not None:
                names[s] = [self.grad_fault(s, g) for g in names[s]]
        return names

    def reference_grads(self, inputs_to_check, weights):
        import jax.numpy as jnp

        from paddle_tpu.core import program as j_program
        from paddle_tpu.core import registry as j_registry

        fwd = self._op(j_program)
        env = self._env(jnp.asarray)
        for s, w in weights.items():
            env[j_program.grad_var_name(f"{s}.out")] = jnp.asarray(
                w.numpy().astype(np.float32))
        for op in j_registry.make_grad_ops(fwd):
            j_registry.run_op(op, env)
        return {s: [np.asarray(env[j_program.grad_var_name(n)])
                    for n in _names(s, _as_list(self.inputs[s]))]
                for s in inputs_to_check}

    def numeric_grads(self, inputs_to_check, weights, delta):
        """Central differences of sum(w * Out) in float64 through the
        port's forward kernel."""
        info = p_registry.get_op_info(self.op_type)
        op = self._op(p_program)
        base = {s: [torch.from_numpy(np.asarray(a, np.float64)
                                     if np.asarray(a).dtype.kind == "f"
                                     else np.asarray(a))
                    for a in _as_list(v)] for s, v in self.inputs.items()}

        def loss():
            ctx = p_registry.OpContext(op, base, torch.device("cpu"))
            outs = p_registry._normalize_outputs(op, info.kernel(ctx))
            return sum(float(torch.sum(outs[s][0].double() * w))
                       for s, w in weights.items() if s in outs)

        grads = {}
        for s in inputs_to_check:
            grads[s] = []
            for t in base[s]:
                g = np.zeros(t.shape)
                flat, gflat = t.view(-1), g.reshape(-1)
                for i in range(flat.numel()):
                    keep = float(flat[i])
                    flat[i] = keep + delta
                    hi = loss()
                    flat[i] = keep - delta
                    lo = loss()
                    flat[i] = keep
                    gflat[i] = (hi - lo) / (2 * delta)
                grads[s].append(g)
        return grads

    def check_grad(self, inputs_to_check, max_relative_error=1e-4,
                   delta=1e-6):
        out = self.port_outputs(torch.float64)
        weights = self._weights(out)
        got = self.port_grads(inputs_to_check, weights)
        want = self.numeric_grads(inputs_to_check, weights, delta)
        for s in inputs_to_check:
            for g, w in zip(got[s], want[s]):
                assert g.shape == w.shape, (s, g.shape, w.shape)
                err = np.abs(g - w) / np.maximum(np.abs(w), 1.0)
                assert float(err.max()) <= max_relative_error, (
                    f"{self.op_type} d{s}: relative error "
                    f"{float(err.max()):.3e} above {max_relative_error:g}")

    def check_grad_with_reference(self, inputs_to_check, rtol=1e-6,
                                  atol=1e-6):
        out = self.port_outputs()
        weights = self._weights(out)
        got = self.port_grads(inputs_to_check, weights)
        want = self.reference_grads(inputs_to_check, weights)
        for s in inputs_to_check:
            for g, w in zip(got[s], want[s]):
                assert g.shape == w.shape, (s, g.shape, w.shape)
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                           equal_nan=True,
                                           err_msg=f"{self.op_type} d{s}")
