"""The port's predictor and InferenceServer on the CPU, each against the
JAX package's predictor on the same model directory (the port's
counterparts of tests/test_inference.py:53-122), and the repairs of C21:
``Executor.close()``, ``Program.list_vars()`` (tests/test_torch_io.py)
and the reference's ``InferenceServer`` parameters in its order.

Models: the MNIST fc net, and the small Transformer of
tests/torch_predictor_setup.py at seq 40 (the plain attention
composition) and seq 300 (the ``sdpa_short`` route's plain version).
fp32 logits agree with the JAX predictor's within 1e-5; bf16 logits lie
within 2^-4 of the largest |fp32 logit| of the same model.
"""
import os
import shutil
import threading

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch.inference import (AnalysisConfig, InferenceServer,
                                        create_paddle_predictor)
from paddle_tpu_torch.inference import serving as PS

import torch_predictor_setup as S

ATOL = 1e-5
BF16_BOUND = 2.0 ** -4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def t40_dir(tmp_path_factory):
    jtest, _, name, w = S.transformer_pair(40)
    d = str(tmp_path_factory.mktemp("t40"))
    S.jax_save(d, jtest, name, w)
    return d


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    jtest, _, name, w = S.mnist_pair()
    d = str(tmp_path_factory.mktemp("mnist"))
    S.jax_save(d, jtest, name, w, feeds=["img"])
    return d


def _img(rows=16, seed=0):
    return {"img": np.random.RandomState(seed).rand(rows, 784).astype(
        np.float32)}


# --- the predictor ----------------------------------------------------------
@pytest.mark.parametrize("model", ["mnist", "t40", "t300"])
def test_run_matches_jax_predictor(model, mnist_dir, t40_dir,
                                   tmp_path):
    if model == "t300":
        jtest, _, name, w = S.transformer_pair(300)
        d = str(tmp_path / "t300")
        S.jax_save(d, jtest, name, w)
        feed = S.token_feed(300)
    else:
        d = mnist_dir if model == "mnist" else t40_dir
        feed = _img() if model == "mnist" else S.token_feed(40)
    pred = S.p_predictor(d)
    assert pred.get_input_names() == list(feed)
    got = S.p_run(pred, feed)
    want = S.j_run(S.j_predictor(d), feed)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert pred.fingerprint() == S.j_predictor(d).fingerprint()


def test_zero_copy_gives_the_bits_of_run(t40_dir):
    pred = S.p_predictor(t40_dir)
    feed = S.token_feed(40)
    want = S.p_run(pred, feed)
    for n, v in feed.items():
        pred.get_input_tensor(n).copy_from_cpu(v)
    pred.zero_copy_run()
    out = pred.get_output_tensor(pred.get_output_names()[0])
    np.testing.assert_array_equal(out.copy_to_cpu(), want)
    with pytest.raises(KeyError):
        pred.get_input_tensor("nope")


@pytest.mark.parametrize("model", ["mnist", "t40"])
def test_ir_optim_shrinks_program_same_output(model, mnist_dir, t40_dir):
    d = mnist_dir if model == "mnist" else t40_dir
    feed = _img() if model == "mnist" else S.token_feed(40)
    raw, opt = S.p_predictor(d, ir=False), S.p_predictor(d)
    n_raw = len(raw.program().global_block.ops)
    types = [o.type for o in opt.program().global_block.ops]
    assert len(types) < n_raw
    assert "fc" in types and "dropout" not in types
    assert [o.type for o in S.j_predictor(d).program().global_block.ops] \
        == types
    np.testing.assert_allclose(S.p_run(opt, feed), S.p_run(raw, feed),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(S.p_run(raw, feed),
                               S.j_run(S.j_predictor(d, ir=False), feed),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("model", ["mnist", "t40"])
def test_bf16_serving_close_to_f32(model, mnist_dir, t40_dir):
    d = mnist_dir if model == "mnist" else t40_dir
    feed = _img() if model == "mnist" else S.token_feed(40)
    pred = S.p_predictor(d, bf16=True)
    floats = [pred._scope._get(n) for n in pred._scope.local_var_names()
              if pred._scope._get(n).is_floating_point()]
    assert floats and all(t.dtype == torch.bfloat16 for t in floats)
    got = S.p_run(pred, feed)
    assert got.dtype == np.float32  # outputs upcast for the caller
    ref = S.p_run(S.p_predictor(d), feed)
    bound = BF16_BOUND * float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= bound
    # the JAX package's bf16 predictor on the same directory: within the
    # same bound of the same fp32 logits
    jgot = S.j_run(S.j_predictor(d, bf16=True), feed)
    assert float(np.abs(jgot - ref).max()) <= bound
    assert float(np.abs(got - jgot).max()) <= 2 * bound
    # bf16 reached the layer norm and attention ops (fp32 never came back)
    if model == "t40":
        assert all(v.dtype.value == "bfloat16" for v in
                   pred.program().list_vars()
                   if v.dtype is not None and "float" in v.dtype.value)


def test_bf16_casts_the_programs_float32_constants(tmp_path):
    """fill_constant's and assign_value's float32 outputs become bf16 at
    load, so the sums run in bf16 as the feed does (ROADMAP C22)."""
    with pf.unique_name.guard():
        main, startup = pf.Program(), pf.Program()
        with pf.program_guard(main, startup):
            x = pf.layers.data("x", shape=[4], dtype="float32")
            c = pf.layers.fill_constant([4], "float32", 0.3)
            t = pf.layers.assign(np.array([0.1, 0.7, -1.3, 2.9],
                                          np.float32))
            y = pf.layers.elementwise_add(pf.layers.elementwise_add(x, c), t)
    d = str(tmp_path / "c")
    S.port_save(d, main, y.name, {}, feeds=["x"])
    pred = S.p_predictor(d, bf16=True)
    kinds = {o.type: o.attrs["dtype"] for o in pred.program().global_block.ops
             if o.type in ("fill_constant", "assign_value")}
    assert kinds == {"fill_constant": "bfloat16", "assign_value": "bfloat16"}
    xs = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    got = S.p_run(pred, {"x": xs})
    bf = torch.bfloat16
    want = (torch.from_numpy(xs).to(bf) + torch.full((4,), 0.3, dtype=bf)
            + torch.tensor([0.1, 0.7, -1.3, 2.9], dtype=bf)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_bf16_keeps_integer_feeds_and_casts_float_feeds(mnist_dir):
    pred = S.p_predictor(mnist_dir, bf16=True)
    seen = {}
    run = pred._prepared.lookup

    def spy(feed):
        seen.update({n: v.dtype for n, v in feed.items()})
        return run(feed)

    pred._prepared.lookup = spy
    S.p_run(pred, _img(4))
    assert seen == {"img": torch.bfloat16}


def test_clone_independent(t40_dir, tmp_path):
    d = str(tmp_path / "copy")
    shutil.copytree(t40_dir, d)
    pred = S.p_predictor(d)
    shared, isolated = pred.clone(), pred.clone(share_cache=False)
    shutil.rmtree(d)  # a clone reads nothing from disk
    feed = S.token_feed(40, seed=4)
    o = S.p_run(pred, feed)
    np.testing.assert_array_equal(S.p_run(shared, feed), o)
    np.testing.assert_array_equal(S.p_run(isolated, feed), o)
    assert shared.program() is pred.program()
    assert shared._exe._cache is pred._exe._cache
    assert isolated.program()._uid != pred.program()._uid
    assert isolated._exe._cache is not pred._exe._cache
    # the clone holds the same parameter tensors: nothing is copied again
    params = [v.name for v in pred.program().list_vars() if v.persistable]
    assert params
    for n in params:
        assert shared._scope._get(n) is pred._scope._get(n)
    shared._config.delete_pass("fc_fuse_pass")
    assert "fc_fuse_pass" in pred._config.all_passes()
    ext = {}
    other = pred.clone(cache=ext)
    S.p_run(other, feed)
    assert other._exe._cache is ext


def test_missing_model_raises():
    cfg = AnalysisConfig()
    cfg.disable_gpu()
    with pytest.raises(ValueError):
        create_paddle_predictor(cfg)


def test_trt_refused():
    cfg = AnalysisConfig("/nonexistent")
    with pytest.raises(RuntimeError, match="enable_tpu_bf16"):
        cfg.enable_tensorrt_engine()


def test_without_a_card_the_predictor_raises(t40_dir):
    """use_gpu is the default: with no card and no disable_gpu() the
    predictor raises; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the predictor runs there")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        create_paddle_predictor(AnalysisConfig(t40_dir))


def test_prog_file_and_params_file(tmp_path):
    jtest, ptest, name, w = S.mnist_pair()
    d = str(tmp_path / "m")
    S.port_save(d, ptest, name, w, feeds=["img"],
                model_filename="model.json", params_filename="params")
    cfg = AnalysisConfig()
    cfg.set_model(os.path.join(d, "model.json"), os.path.join(d, "params"))
    cfg.disable_gpu()
    pred = create_paddle_predictor(cfg)
    feed = _img(3)
    got = S.p_run(pred, feed)
    h = feed["img"]
    for i in range(3):
        h = h @ w[f"fc_{i}.w_0"] + w[f"fc_{i}.b_0"]
        h = np.maximum(h, 0) if i < 2 else h
    np.testing.assert_allclose(got, h, rtol=1e-5, atol=1e-5)


# --- C21: Executor.close ----------------------------------------------------
def test_executor_close_empties_the_cache_and_prepares_again(t40_dir):
    pred = S.p_predictor(t40_dir)
    feed = S.token_feed(40)
    S.p_run(pred, feed)
    S.p_run(pred, feed)
    assert pred._prepared.prepare_count == 1
    exe, scope = pf.Executor(pf.CPUPlace()), pred._scope
    exe.run(pred.program(), feed=feed, fetch_list=pred.get_output_names(),
            scope=scope)
    assert len(exe._cache) == 1
    exe.close()
    assert len(exe._cache) == 0
    exe.run(pred.program(), feed=feed, fetch_list=pred.get_output_names(),
            scope=scope)
    assert len(exe._cache) == 1 and exe.cache_hit_count == 0
    pred._exe.close()
    o = S.p_run(pred, feed)
    assert pred._prepared.prepare_count == 2
    np.testing.assert_array_equal(o, S.p_run(pred, feed))


# --- InferenceServer --------------------------------------------------------
def _serve(server, rows):
    """One threaded batch-1 submit per row of `rows` ({name: [N, ...]})."""
    n = len(next(iter(rows.values())))
    out = [None] * n

    def one(i):
        out[i] = server.infer({k: v[i:i + 1] for k, v in rows.items()})[0]

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return np.concatenate(out)


@pytest.mark.parametrize("over", ["predictor", "runner"])
def test_server_gives_the_predictor_outputs(over, t40_dir):
    pred = S.p_predictor(t40_dir)
    rows = S.token_feed(40, rows=12, seed=5)
    want = S.p_run(pred, rows)
    if over == "predictor":
        target = pred
    else:
        target = PS.ProgramRunner(pred.program(), pred.get_input_names(),
                                  pred.get_output_names(),
                                  executor=pf.Executor(pf.CPUPlace()),
                                  scope=pred._scope)
    with InferenceServer(target, max_batch_size=4,
                         max_wait_ms=50.0) as srv:
        got = _serve(srv, rows)
        st = srv.stats()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert st["requests"] == st["completed"] == 12
    assert st["batches"] < st["requests"]
    assert not srv._running and srv._thread is None


def test_server_takes_the_reference_parameter_order(t40_dir):
    """C21: (predictor_or_runner, max_batch_size, max_wait_ms,
    batch_buckets, seq_buckets, select_group, start), as
    paddle_tpu/inference/serving.py:461-467."""
    pred = S.p_predictor(t40_dir)
    srv = InferenceServer(pred, 4, 1.0, [4, 1, 2], None, None, False)
    assert (srv.max_batch_size, srv.max_wait_ms, srv.batch_buckets) == \
        (4, 1.0, [1, 2, 4])
    assert srv._thread is None  # start=False, the 7th
    srv.start()
    rows = S.token_feed(40, rows=3, seed=6)
    np.testing.assert_allclose(_serve(srv, rows), S.p_run(pred, rows),
                               rtol=0, atol=ATOL)
    srv.close()
    with pytest.raises(ValueError, match="do not cover"):
        InferenceServer(pred, 8, 1.0, [1, 2, 4], start=False)
    # the 5th and 6th: the sequence ladder and the group hook
    hook = lambda groups: None  # noqa: E731
    srv = InferenceServer(pred, 4, 1.0, None, [64, 48], hook, False)
    assert srv.seq_buckets == [48, 64] and srv._select_group_hook is hook


def test_server_settings_precedence(t40_dir):
    """argument > the config's enable_dynamic_batching > default."""
    cfg = AnalysisConfig(t40_dir)
    cfg.disable_gpu()
    cfg.enable_dynamic_batching(max_batch_size=6, max_wait_ms=7.0,
                                batch_buckets=[2, 6])
    pred = create_paddle_predictor(cfg)
    srv = InferenceServer(pred, start=False)
    assert (srv.max_batch_size, srv.max_wait_ms, srv.batch_buckets) == \
        (6, 7.0, [2, 6])
    srv = InferenceServer(pred, max_batch_size=2, start=False)
    assert (srv.max_batch_size, srv.max_wait_ms) == (2, 7.0)
    plain = S.p_predictor(t40_dir)
    srv = InferenceServer(plain, start=False)
    assert (srv.max_batch_size, srv.max_wait_ms, srv.batch_buckets) == \
        (8, 2.0, [1, 2, 4, 8])
    cfg.enable_dynamic_batching(seq_buckets=[64])
    srv = InferenceServer(create_paddle_predictor(cfg), start=False)
    assert srv.seq_buckets == [64]
    assert InferenceServer(create_paddle_predictor(cfg), seq_buckets=[48],
                           start=False).seq_buckets == [48]
