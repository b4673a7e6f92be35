"""Export of the port against the JAX package on the CPU: the Scope API,
Program serialization (``to_dict``/``from_dict`` across packages,
``list_vars``, ``_prune``, ``fingerprint``), the PTPF decoder, and
``io.py`` both ways: a model directory saved by either package (PTPF +
.meta, JSON, or a reference protobuf) loads in the other and gives the
same logits within 1e-5; the params files the port writes equal the JAX
package's byte for byte.
"""
import json
import os
import shutil
import struct
import zipfile

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import native as j_native
from paddle_tpu.core import compile_cache as j_cc
from paddle_tpu_torch.core import program as p_program
from paddle_tpu_torch.native import ptpf

import torch_predictor_setup as S

ATOL = 1e-5
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
PROTO_MODEL = os.path.join(FIXDIR, "mnist_fc_program.__model__")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def t40():
    return S.transformer_pair(40)


def _norm(d):
    """A program dict as the JAX package's digest sees it."""
    return json.loads(json.dumps(d, sort_keys=True, default=j_cc._canon))


# --- Scope -----------------------------------------------------------------
def _scope_trace(mod, make):
    """The same calls on a scope of `mod`; what each returns."""
    s = mod.Scope()
    out = [s.find_var("a") is None, s.has("a")]
    v = s.var("a")
    out += [v.name, s.has("a"), s.local_var_names()]
    v.get_tensor().set(np.arange(6, dtype=np.float32).reshape(2, 3))
    t = s.find_var("a").get_tensor()
    out += [s.has("a"), t.shape(), np.asarray(t).tolist(), t.lod()]
    t.set_lod([[0, 1, 2]])
    out.append(s.find_var("a").get_tensor().lod())
    kid = s.new_scope()
    out += [kid.find_var("a") is not None, kid.has("a"),
            kid.local_var_names()]
    kid.var("b").get_tensor().set(make(np.ones(2, np.float32)))
    out += [s.has("b"), kid.has("b"), np.asarray(
        kid.find_var("b").get_tensor()).tolist()]
    s.drop_kids()
    s.erase("a")
    out += [s.has("a"), s.find_var("a") is None, s.local_var_names(),
            s.find_var("a") is None and kid.find_var("b") is not None]
    return out


def test_scope_api_matches_reference():
    want = _scope_trace(jf, np.asarray)
    assert _scope_trace(pf, torch.from_numpy) == want
    assert _scope_trace(pf, np.asarray) == want


def test_scope_get_tensor_gives_numpy_from_bf16():
    s = pf.Scope()
    s.var("w").get_tensor().set(torch.ones(3, dtype=torch.bfloat16))
    arr = np.asarray(s.find_var("w").get_tensor())
    assert arr.dtype == np.float32 and arr.tolist() == [1.0, 1.0, 1.0]
    assert isinstance(s._get("w"), torch.Tensor)


# --- Program ---------------------------------------------------------------
def test_program_list_vars_matches_reference(t40):
    """C21: Program.list_vars, every var of every block in the
    reference's order."""
    jtest, ptest, _, _ = t40
    assert [v.name for v in ptest.list_vars()] == \
        [v.name for v in jtest.list_vars()]
    assert len(list(ptest.list_vars())) == sum(
        len(b.vars) for b in ptest.blocks)


def _int_drift(jd, pd):
    """The vars whose dtype is int32 in the JAX package and int64 in the
    port (JAX without x64 narrows integer results; ROADMAP "Paths
    already checked"), with the rest of both dicts equal."""
    drift = []
    for jb, pb in zip(jd["blocks"], pd["blocks"]):
        for jv, pv in zip(jb["vars"], pb["vars"]):
            if jv != pv:
                assert (jv["dtype"], pv["dtype"]) == ("int32", "int64") \
                    and dict(jv, dtype=None) == dict(pv, dtype=None), \
                    (jv, pv)
                drift.append(jv["name"])
                pv["dtype"] = "int32"
    assert pd == jd
    return drift


@pytest.mark.parametrize("which", ["transformer", "mnist"])
def test_to_dict_equal_and_cross_from_dict(which, t40):
    jtest, ptest, name, _ = t40 if which == "transformer" \
        else S.mnist_pair()
    # the exported (pruned) program: equal key for key
    jp, pp = jtest._prune([name]), ptest._prune([name])
    jd, pd = _norm(jp.to_dict()), _norm(pp.to_dict())
    assert pd == jd
    assert pp.fingerprint() == jp.fingerprint()
    # each package reads the other's dict and writes it back unchanged
    assert _norm(p_program.Program.from_dict(jp.to_dict()).to_dict()) \
        == jd
    assert _norm(jf.Program.from_dict(pp.to_dict()).to_dict()) == pd
    # the whole test clone: the label's unsqueeze alone is int64 here
    drift = _int_drift(_norm(jtest.to_dict()), _norm(ptest.to_dict()))
    assert len(drift) == (1 if which == "transformer" else 0), drift


def test_prune_keeps_the_same_ops_and_io(t40):
    jtest, ptest, name, _ = t40
    jp, pp = jtest._prune([name]), ptest._prune([name])
    assert [(o.type, o.inputs, o.outputs) for o in pp.global_block.ops] \
        == [(o.type, o.inputs, o.outputs) for o in jp.global_block.ops]
    assert sorted(pp.global_block.vars) == sorted(jp.global_block.vars)
    assert sorted(pp._parameters) == sorted(jp._parameters)
    types = {o.type for o in pp.global_block.ops}
    assert "softmax_with_cross_entropy" not in types and "dropout" in types


def test_fingerprint_cached_per_version_and_moved_by_a_pass(t40):
    _, ptest, name, _ = t40
    p = ptest._prune([name])
    before = p.fingerprint()
    assert p.fingerprint() == before
    pf.ir.apply_passes(p, ["dropout_eliminate_pass"], protected={name})
    assert p.fingerprint() != before


def test_clone_for_test_sets_is_test_as_the_reference(t40):
    jtest, ptest, _, _ = t40
    for jop, pop in zip(jtest.global_block.ops, ptest.global_block.ops):
        assert (pop.type, pop.attrs.get("is_test")) == \
            (jop.type, jop.attrs.get("is_test"))
    assert all(op.attrs["is_test"] for op in ptest.global_block.ops
               if op.type == "dropout")


# --- PTPF --------------------------------------------------------------------
def test_ptpf_decoder_equals_native_to_dict(t40):
    if not j_native.available():
        pytest.skip("the JAX package's C++ core does not build here")
    jtest, _, name, _ = t40
    d = jtest._prune([name]).to_dict()
    # an attr of each PTPF tag the program lacks
    d["blocks"][0]["ops"][0]["attrs"].update(
        {"t_none": None, "t_bools": [True, False], "t_strs": ["a", "bc"],
         "t_floats": [1.5, -2.0], "t_ints": [], "t_block": {"__block__": 0},
         "t_nd_i": {"__ndarray__": [1, -2, 3], "dtype": "int32",
                    "shape": [3]},
         "t_nd_bf": {"__ndarray__": [1.0, 0.5], "dtype": "bfloat16",
                     "shape": [2]}})
    raw = j_native.NativeProgram.from_dict(d).to_bytes()
    assert raw[:4] == b"PTPF"
    want = j_native.NativeProgram.from_bytes(raw).to_dict()
    assert ptpf.from_bytes(raw) == want
    with pytest.raises(ValueError):
        ptpf.from_bytes(raw[:len(raw) // 2])
    with pytest.raises(ValueError):
        ptpf.from_bytes(b"JSON" + raw[4:])


# --- io: model directories both ways ---------------------------------------
def _files(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("form", ["ptpf", "json"])
def test_jax_saved_model_loads_in_the_port(form, t40, tmp_path):
    jtest, _, name, w = t40
    d = str(tmp_path / form)
    if form == "json":
        with S.jax_json_only():
            S.jax_save(d, jtest, name, w)
    else:
        if not j_native.available():
            pytest.skip("the JAX package's C++ core does not build here")
        S.jax_save(d, jtest, name, w)
        assert "__model__.meta" in _files(d)
    with open(os.path.join(d, "__model__"), "rb") as f:
        assert (f.read(4) == b"PTPF") == (form == "ptpf")
    feed = S.token_feed(40)
    want = S.j_run(S.j_predictor(d), feed)
    got = S.p_run(S.p_predictor(d), feed)
    assert got.shape == (2, 40, S.SMALL["vocab"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the raw load too: the program the port reads equals the JAX one's
    scope = pf.Scope()
    with pf.scope_guard(scope):
        prog, feeds, fetch = pf.load_inference_model(
            d, pf.Executor(pf.CPUPlace()))
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jprog, jfeeds, _ = jf.load_inference_model(
            d, jf.Executor(jf.CPUPlace()))
    assert (feeds, [v.name for v in fetch]) == (jfeeds, [name])
    assert prog.fingerprint() == jprog.fingerprint()
    for n in jscope.local_var_names():
        np.testing.assert_array_equal(scope._get(n).numpy(),
                                      np.asarray(jscope._get(n)))


def test_port_saved_model_loads_in_jax(t40, tmp_path):
    _, ptest, name, w = t40
    d = str(tmp_path / "port")
    S.port_save(d, ptest, name, w)
    with open(os.path.join(d, "__model__")) as f:
        model = json.load(f)
    assert model["feed_names"] == S.FEEDS and model["fetch_names"] == [name]
    feed = S.token_feed(40, seed=1)
    want = S.p_run(S.p_predictor(d), feed)
    got = S.j_run(S.j_predictor(d), feed)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_port_json_model_equals_jax_json_model(t40, tmp_path):
    """The same program and weights: the JSON each package writes holds
    the same model."""
    jtest, ptest, name, w = t40
    jd, pd = str(tmp_path / "j"), str(tmp_path / "p")
    with S.jax_json_only():
        S.jax_save(jd, jtest, name, w)
    S.port_save(pd, ptest, name, w)
    with open(os.path.join(jd, "__model__")) as f:
        jm = json.load(f)
    with open(os.path.join(pd, "__model__")) as f:
        pm = json.load(f)
    assert _norm(pm) == _norm(jm)
    assert _files(pd) == _files(jd)


def _fixed_zip_time(monkeypatch):
    """np.savez stamps each member with the time; hold it fixed."""
    monkeypatch.setattr(zipfile.time, "time", lambda: 1.7e9)


@pytest.mark.parametrize("combined", [False, True])
def test_params_files_equal_reference_bytes(combined, t40, tmp_path,
                                            monkeypatch):
    jtest, ptest, name, w = t40
    if combined:
        _fixed_zip_time(monkeypatch)
    kw = {"params_filename": "__params__"} if combined else {}
    jd, pd = str(tmp_path / "j"), str(tmp_path / "p")
    with S.jax_json_only():
        S.jax_save(jd, jtest, name, w, **kw)
    S.port_save(pd, ptest, name, w, **kw)
    names = [n for n in _files(jd) if n != "__model__"]
    assert names == [n for n in _files(pd) if n != "__model__"]
    assert len(names) == (1 if combined else len(w))
    for n in names:
        with open(os.path.join(jd, n), "rb") as a, \
                open(os.path.join(pd, n), "rb") as b:
            assert a.read() == b.read(), n


def test_save_load_params_and_persistables_round_trip(t40, tmp_path):
    _, ptest, name, w = t40
    exe = pf.Executor(pf.CPUPlace())
    scope = pf.Scope()
    pf.load_numpy_params(scope, w, pf.CPUPlace())
    with pf.scope_guard(scope):
        pf.save_params(exe, str(tmp_path / "a"), ptest)
        pf.save_persistables(exe, str(tmp_path / "b"), ptest,
                             filename="all")
    for d, fn, load in (("a", None, pf.load_params),
                        ("b", "all", pf.load_persistables)):
        back = pf.Scope()
        with pf.scope_guard(back):
            load(exe, str(tmp_path / d), ptest, filename=fn)
        assert sorted(back.local_var_names()) == sorted(w)
        for n, a in w.items():
            np.testing.assert_array_equal(back._get(n).numpy(), a)


def test_load_quirks_as_the_reference(t40, tmp_path):
    """A missing per-var file is skipped; a reference combined stream
    whose count differs from the program's persistables raises."""
    _, ptest, name, w = t40
    d = str(tmp_path / "m")
    S.port_save(d, ptest, name, w)
    gone = sorted(w)[0]
    os.remove(os.path.join(d, gone))
    scope = pf.Scope()
    with pf.scope_guard(scope):
        pf.load_persistables(pf.Executor(pf.CPUPlace()), d, ptest)
    assert not scope.has(gone) and scope.has(sorted(w)[1])
    with open(str(tmp_path / "combined"), "wb") as f:
        f.write(_lod_tensor(np.ones(3, np.float32)))
    with pytest.raises(ValueError, match="combined params file"):
        pf.load_vars(pf.Executor(pf.CPUPlace()), str(tmp_path), ptest,
                     vars=[ptest.global_block.var(n) for n in sorted(w)[:2]],
                     filename="combined")


# --- the reference protobuf __model__ -------------------------------------
def _varint(x):
    out = b""
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _lod_tensor(arr):
    """One reference LoDTensor stream (lod_tensor.cc:246)."""
    desc = bytes([0x08, 5])
    for d in arr.shape:
        desc += bytes([0x10]) + _varint(d)
    return (struct.pack("<I", 0) + struct.pack("<Q", 0)
            + struct.pack("<I", 0) + struct.pack("<i", len(desc)) + desc
            + arr.tobytes())


@pytest.mark.parametrize("combined", [False, True])
def test_reference_protobuf_model_runs_as_in_jax(combined, tmp_path):
    """tests/test_proto_import.py:117, :145 on the port: the reference's
    __model__ with per-var or combined (sorted-name) LoDTensor params."""
    d = str(tmp_path / "ref")
    os.makedirs(d)
    shutil.copy(PROTO_MODEL, os.path.join(d, "__model__"))
    r = np.random.RandomState(3)
    w = r.randn(8, 4).astype(np.float32)
    b = r.randn(4).astype(np.float32)
    kw = {}
    if combined:
        with open(os.path.join(d, "__params__"), "wb") as f:
            f.write(_lod_tensor(b) + _lod_tensor(w))
        kw = {"params_filename": "__params__"}
    else:
        for n, a in (("fc_w", w), ("fc_b", b)):
            with open(os.path.join(d, n), "wb") as f:
                f.write(_lod_tensor(a))
    x = r.randn(16, 8).astype(np.float32)
    scope = pf.Scope()
    with pf.scope_guard(scope):
        prog, feeds, fetch = pf.load_inference_model(
            d, pf.Executor(pf.CPUPlace()), **kw)
    got, = pf.Executor(pf.CPUPlace()).run(prog, feed={"img": x},
                                          fetch_list=fetch, scope=scope)
    jscope = jf.Scope()
    with jf.scope_guard(jscope):
        jprog, jfeeds, jfetch = jf.load_inference_model(
            d, jf.Executor(jf.CPUPlace()), **kw)
    want, = jf.Executor(jf.CPUPlace()).run(
        jprog, feed={"img": x}, fetch_list=jfetch, scope=jscope)
    assert feeds == jfeeds == ["img"]
    assert prog.fingerprint() == jprog.fingerprint()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    logits = x @ w + b
    e = np.exp(logits - logits.max(1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(1, keepdims=True),
                               rtol=1e-5, atol=1e-6)


def test_loaded_values_stay_on_the_host_until_a_run_reads_them(t40,
                                                               tmp_path):
    _, ptest, name, w = t40
    d = str(tmp_path / "m")
    S.port_save(d, ptest, name, w)
    scope = pf.Scope()
    with pf.scope_guard(scope):
        pf.load_inference_model(d, pf.Executor(pf.CPUPlace()))
    assert all(scope._get(n).device.type == "cpu" for n in w)
