"""Dropout in the port: the ``dropout`` op and its grad, the
``attention`` op's dropout branch, the device step key they draw from
(``OpContext.keep_mask``), and ``run_steps`` over them.

Random ops cannot match the JAX package bit for bit (its masks come from
``jax.random``), so these tests hold the port to distributions and to
its own contract:
- exact at rate 0 and at is_test (both implementations);
- the keep rate within 5 standard deviations of the binomial's;
- masks differ across steps and across ops, and a `seed` attr repeats
  them;
- the grads read the forward's mask, exactly;
- `run_steps` K steps equal K `run` calls bit for bit;
- the draw is SplitMix64 on int64 tensors, the same bits as the host's
  `splitmix64` (so the CPU and the card draw the same masks).
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.core import executor as p_executor
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.ops import nn_ops as p_nn_ops

IMPLS = ["upscale_in_train", "downgrade_in_infer"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dropout_program(pkg, p, impl, shape=(64, 256), is_test=False,
                     seed=None, n_ops=1, grad=False):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 3
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=list(shape[1:]), dtype="float32")
        outs = [pkg.layers.dropout(x, p, is_test=is_test, seed=seed,
                                   dropout_implementation=impl)
                for _ in range(n_ops)]
        if grad:
            x.stop_gradient = False
            loss = pkg.layers.mean(outs[0])
            pkg.backward.append_backward(loss)
    masks = [op.outputs["Mask"][0] for op in main.global_block.ops
             if op.type == "dropout"]
    return main, [o.name for o in outs], masks


def _x(shape=(64, 256), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(main, fetch, feed, scope=None, exe=None):
    exe = exe or pf.Executor(pf.CPUPlace())
    return exe.run(main, feed=feed, fetch_list=fetch,
                   scope=scope or pf.Scope())


@pytest.mark.parametrize("impl", IMPLS)
def test_rate_zero_and_is_test_are_exact(impl):
    """p = 0 keeps every element; is_test returns x (upscale_in_train)
    or x (1 - p) (downgrade_in_infer), in both packages."""
    x = _x()
    for p, is_test in ((0.0, False), (0.3, True)):
        want = x if (impl == "upscale_in_train" or not is_test) \
            else x * np.float32(1.0 - p)
        for pkg, un in ((pf, p_unique_name), (jf, jf.unique_name)):
            with un.guard():
                main, outs, masks = _dropout_program(pkg, p, impl,
                                                     is_test=is_test)
            if pkg is pf:
                out, mask = _run(main, outs + masks, {"x": x})
            else:
                out, mask = jf.Executor(jf.CPUPlace()).run(
                    main, feed={"x": x}, fetch_list=outs + masks,
                    scope=jf.Scope())
            np.testing.assert_array_equal(np.asarray(out), want)
            np.testing.assert_array_equal(np.asarray(mask),
                                          np.ones_like(x))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("impl", IMPLS)
def test_keep_rate_and_scaling(p, impl):
    """The share kept lies within 5 standard deviations of 1 - p, the
    mask is 0/1 in x's dtype, and Out = x mask (/ (1 - p)) exactly; the
    JAX package's keep share lies within the same band."""
    x = _x((256, 512), seed=1)
    with p_unique_name.guard():
        main, outs, masks = _dropout_program(pf, p, impl, shape=x.shape)
    out, mask = _run(main, outs + masks, {"x": x})
    n = mask.size
    band = 5 * np.sqrt(p * (1 - p) / n)
    assert set(np.unique(mask)) <= {0.0, 1.0}
    assert abs(mask.mean() - (1 - p)) <= band, (mask.mean(), 1 - p)
    scale = 1.0 / (1.0 - p) if impl == "upscale_in_train" else 1.0
    want = torch.from_numpy(x) * torch.from_numpy(mask)
    if impl == "upscale_in_train":
        want = want / (1.0 - p)
    np.testing.assert_array_equal(out, want.numpy())
    assert np.all((out == 0) == (mask == 0) | (x == 0)), scale
    with jf.unique_name.guard():
        jmain, jouts, jmasks = _dropout_program(jf, p, impl, shape=x.shape)
    jmask = np.asarray(jf.Executor(jf.CPUPlace()).run(
        jmain, feed={"x": x}, fetch_list=jmasks, scope=jf.Scope())[0])
    assert abs(jmask.mean() - (1 - p)) <= band


def test_masks_differ_across_steps_and_ops_and_a_seed_repeats_them():
    x = _x()
    with p_unique_name.guard():
        main, outs, masks = _dropout_program(pf, 0.5, IMPLS[0], n_ops=2)
    scope, exe = pf.Scope(), pf.Executor(pf.CPUPlace())
    a1, b1 = _run(main, masks, {"x": x}, scope, exe)
    a2, b2 = _run(main, masks, {"x": x}, scope, exe)
    assert not np.array_equal(a1, b1)      # two ops
    assert not np.array_equal(a1, a2)      # two steps
    # a fresh scope restarts the step key: the same masks again
    a3, b3 = _run(main, masks, {"x": x}, pf.Scope(), exe)
    np.testing.assert_array_equal(a1, a3)
    np.testing.assert_array_equal(b1, b3)
    # a `seed` attr pins the draw: every step the same, another seed not
    with p_unique_name.guard():
        smain, _, smasks = _dropout_program(pf, 0.5, IMPLS[0], seed=7)
    s1 = _run(smain, smasks, {"x": x}, scope, exe)[0]
    s2 = _run(smain, smasks, {"x": x}, scope, exe)[0]
    np.testing.assert_array_equal(s1, s2)
    with p_unique_name.guard():
        omain, _, omasks = _dropout_program(pf, 0.5, IMPLS[0], seed=8)
    assert not np.array_equal(s1, _run(omain, omasks, {"x": x})[0])


@pytest.mark.parametrize("impl", IMPLS)
def test_dropout_grad_reads_the_forward_mask(impl):
    """X@GRAD = Out@GRAD * Mask (/ (1 - p)) with the Mask the forward
    wrote, not a redraw; the grad op reads Mask and Out@GRAD only."""
    x = _x((32, 64), seed=2)
    p = 0.3
    with p_unique_name.guard():
        main, outs, masks = _dropout_program(pf, p, impl, shape=x.shape,
                                             grad=True)
    gop = next(op for op in main.global_block.ops
               if op.type == "dropout_grad")
    assert sorted(gop.inputs) == ["Mask", "Out@GRAD"]
    mask, dx = _run(main, masks + ["x@GRAD"], {"x": x})
    want = mask / mask.size
    if impl == "upscale_in_train":
        want = want / (1.0 - p)
    np.testing.assert_allclose(dx, want, rtol=1e-6, atol=0)
    assert ((dx == 0) == (mask == 0)).all()


def _attention_program(rate, causal, shape=(2, 40, 2, 16)):
    main = pf.Program()
    main.random_seed = 5
    blk = main.global_block
    for n in ("Q", "K", "V"):
        blk.create_var(name=n, shape=shape, dtype="float32")
    op = blk.append_op("attention", {"Q": ["Q"], "K": ["K"], "V": ["V"]},
                       {"Out": ["O"]},
                       {"causal": causal, "scale": shape[-1] ** -0.5,
                        "layout": "bthd", "dropout_rate": rate})
    return main, op


def _attention_with_mask(q, k, v, keep, rate, scale, causal):
    """The attention op's dropout composition on bthd q, k, v with a
    given [B,H,tq,tk] keep mask, written out in torch."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2:]
        m = torch.ones(tq, tk, dtype=torch.bool).tril(tk - tq)
        s = s.masked_fill(~m, torch.finfo(s.dtype).min)
    p = torch.softmax(s, -1) * keep / (1.0 - rate)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dropout_grad_is_the_analytic_grad_with_the_mask(causal):
    """The attention op with dropout 0.2 on the CPU: its output equals
    the composition under the mask the op's first draw gives (the
    program seed and the scope's first step key, the op's uid, call 0),
    and its grad op's Q, K, V grads equal autograd of that composition
    under the same mask: the vjp recompute draws the forward's mask."""
    rate, shape = 0.2, (2, 40, 2, 16)
    main, op = _attention_program(rate, causal, shape)
    (gop,) = registry.make_grad_ops(op)
    rs = np.random.RandomState(3)
    env = {n: torch.from_numpy(rs.randn(*shape).astype(np.float32))
           for n in ("Q", "K", "V", "O@GRAD")}
    key = torch.tensor(5)  # a fresh scope's first key: the program seed
    keep = registry.keep_bits(key, registry.mix64(5, op._uid, 0),
                              (2, 2, 40, 40), 1 - rate).float()
    assert 0 < keep.mean() < 1
    qkv = [env[n].clone().requires_grad_() for n in ("Q", "K", "V")]
    want = _attention_with_mask(*qkv, keep, rate, shape[-1] ** -0.5,
                                causal)
    wgrads = torch.autograd.grad(want, qkv, env["O@GRAD"])
    with torch.no_grad():
        registry.run_op(op, env, torch.device("cpu"), seed=5, key=5,
                        dkey=key)
        registry.run_op(gop, env, torch.device("cpu"), seed=5, key=5,
                        dkey=key)
    torch.testing.assert_close(env["O"], want.detach(), rtol=1e-5,
                               atol=1e-6)
    for n, w in zip(("Q", "K", "V"), wgrads):
        torch.testing.assert_close(env[n + "@GRAD"], w, rtol=1e-5,
                                   atol=1e-6)
    # a program run through the Executor draws that mask at its first
    # step
    exe = pf.Executor(pf.CPUPlace())
    out = exe.run(main, feed={n: env[n].numpy() for n in ("Q", "K", "V")},
                  fetch_list=["O"], scope=pf.Scope())[0]
    np.testing.assert_allclose(out, want.detach().numpy(), rtol=1e-5,
                               atol=1e-6)


def test_attention_dropout_is_test_and_rate_zero_are_the_plain_op():
    """is_test (or rate 0) takes the no-dropout path: the same output as
    the op without the attr."""
    shape = (1, 30, 2, 16)
    rs = np.random.RandomState(4)
    vals = {n: torch.from_numpy(rs.randn(*shape).astype(np.float32))
            for n in ("Q", "K", "V")}
    outs = []
    for rate, is_test in ((0.0, False), (0.5, True)):
        _, op = _attention_program(rate, True, shape)
        op.attrs["is_test"] = is_test
        env = dict(vals)
        registry.run_op(op, env, torch.device("cpu"))
        outs.append(env["O"])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    np.testing.assert_array_equal(
        outs[0].numpy(), p_nn_ops._sdpa(vals["Q"], vals["K"], vals["V"],
                                        16 ** -0.5, True, "bthd").numpy())


def _transformer(dropout_rate):
    from paddle_tpu_torch.models import transformer as PT

    with p_unique_name.guard():
        main, startup, cost = PT.build_program(
            seq_len=12, d_model=32, n_heads=2, n_layers=1, d_inner=64,
            vocab=40, dropout_rate=dropout_rate, warmup_steps=10)
    startup.random_seed = 1
    main.random_seed = 2
    return main, startup, cost


def _tfeed(seed=0, batch=3):
    rs = np.random.RandomState(seed)
    return {k: rs.randint(0, 40, (batch, 12)).astype("int64")
            for k in ("src_ids", "tgt_ids", "label")}


def test_transformer_with_dropout_builds_the_reference_ops():
    """The training program at dropout 0.1 holds the JAX package's
    dropout ops (embeddings, FFN hidden, before each add-norm) and
    attention ops with dropout_rate 0.1, in the same places."""
    from paddle_tpu.models import transformer as JT

    main, _, _ = _transformer(0.1)
    with jf.unique_name.guard():
        jmain, _, _ = JT.build_program(
            seq_len=12, d_model=32, n_heads=2, n_layers=1, d_inner=64,
            vocab=40, dropout_rate=0.1, warmup_steps=10)
    got = [(op.type, op.attrs.get("dropout_rate", op.attrs.get(
        "dropout_prob"))) for op in main.global_block.ops
        if op.type in ("dropout", "attention", "dropout_grad",
                       "attention_grad")]
    want = [(op.type, op.attrs.get("dropout_rate", op.attrs.get(
        "dropout_prob"))) for op in jmain.global_block.ops
        if op.type in ("dropout", "attention", "dropout_grad",
                       "attention_grad")]
    assert got == want
    assert ("dropout", 0.1) in got and ("attention", 0.1) in got


def test_run_steps_equals_k_runs_with_dropout():
    """K run_steps steps of the training program at dropout 0.1 equal K
    run calls bit for bit (losses and every persistable), from the same
    seeded state; the program is one a CUDA graph takes (no eager
    reason), and its losses differ from the dropout-0 program's."""
    main, startup, cost = _transformer(0.1)
    exe = pf.Executor(pf.CPUPlace())
    feeds = [_tfeed(s) for s in range(3)]
    states = []
    for mode in ("run", "run_steps"):
        scope = pf.Scope()
        exe.run(startup, scope=scope)
        if mode == "run":
            losses = [exe.run(main, feed=f, fetch_list=[cost],
                              scope=scope)[0] for f in feeds]
        else:
            losses = list(exe.run_steps(main, feed=feeds,
                                        fetch_list=[cost], scope=scope)[0])
            assert exe.last_run_steps_fallback is None
        states.append((np.array(losses).ravel(),
                       {n: scope._get(n).clone() for n in scope._vars}))
    np.testing.assert_array_equal(states[0][0], states[1][0])
    for n, v in states[0][1].items():
        assert torch.equal(v, states[1][1][n]), n
    assert p_executor._capture_fallback_reason(main) is None
    nmain, nstartup, ncost = _transformer(0.0)
    scope = pf.Scope()
    exe.run(nstartup, scope=scope)
    plain = exe.run(nmain, feed=feeds[0], fetch_list=[ncost],
                    scope=scope)[0]
    assert not np.array_equal(plain.ravel(), states[0][0][:1])


def test_device_key_follows_the_host_key():
    """The device copy of the step key advances with the host's
    arithmetic: after each run it holds the host's next key; `seed`
    restarts both."""
    main, outs, masks = _dropout_program(pf, 0.5, IMPLS[0])
    exe, scope = pf.Executor(pf.CPUPlace()), pf.Scope()
    for _ in range(3):
        _run(main, masks, {"x": _x()}, scope, exe)
        host, dev = scope._device_key
        assert host == int(scope._get(p_executor.RNG_VAR))
        assert int(dev) == host


def _splitmix64_np(x):
    """SplitMix64 on uint64 numpy arrays (wrapping products)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def test_keep_bits_is_splitmix64():
    """keep_bits' int64 arithmetic gives SplitMix64's bit patterns: the
    same as numpy's uint64 version and as the host's splitmix64, and
    advance_key_t is the Executor's host-side step."""
    key, salt, n = 123456789, registry.mix64(7, 9, 0), 4096
    base = _splitmix64_np(np.array([key ^ salt], np.uint64))[0]
    with np.errstate(over="ignore"):
        z = _splitmix64_np(base + np.arange(n, dtype=np.uint64)
                           * np.uint64(0x9E3779B97F4A7C15))
    want = (z >> np.uint64(40)) < np.uint64(round(0.3 * (1 << 24)))
    got = registry.keep_bits(torch.tensor(key), salt, (n,), 0.3)
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (0, 1, 2 ** 62 + 12345, 2 ** 63 - 1):
        assert int(registry.advance_key_t(torch.tensor(k))) == \
            registry.splitmix64(k) >> 1
        v = registry.splitmix64_t(torch.tensor(registry._signed(k)))
        assert int(v) & ((1 << 64) - 1) == registry.splitmix64(k)
