"""Checkpoint and model save/load (the port's counterpart of
``paddle_tpu/io.py``; reference python/paddle/fluid/io.py).

Scope values are written as numpy streams: one ``.npy`` file a var, or
one combined ``.npz`` file; for the same arrays the bytes are the JAX
package's. ``save_inference_model`` prunes the program to its fetch
targets and writes ``__model__`` as JSON (program dict, feed and fetch
names) beside the params. ``load_inference_model`` reads that JSON, the
JAX package's binary PTPF program with its ``.meta`` sidecar
(``native/ptpf.py``), or a reference protobuf ``ProgramDesc``
(``inference/proto_import.py``); params as ``.npy``/``.npz`` or the
reference's raw LoDTensor streams, the combined one in sorted-name order.

Loaded values land in the scope on the host; the Executor moves each to
its device the first time a run reads it. The sharded and distributed
persistables of the JAX package are not ported yet.
"""
from __future__ import annotations

import io as _io
import json
import os
from typing import List

import numpy as np
import torch

from .core.program import Program, Variable, _canon, default_main_program
from .core.scope import global_scope
from .core.types import VarType

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "get_program_parameter",
           "get_program_persistable_vars"]

_MODEL_FILE = "__model__"


def _is_persistable(var: Variable):
    return var.persistable and not var.is_data


def get_program_parameter(program):
    return program.all_parameters()


def get_program_persistable_vars(program):
    return [v for v in program.list_vars() if _is_persistable(v)]


def _host_array(value) -> np.ndarray:
    """A scope value as numpy; numpy has no bf16, so a bf16 tensor is
    written widened to float32, which holds it exactly."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(value)


def _save_array(path, arr):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path + ".npy", arr, allow_pickle=False)
    if os.path.exists(path):
        os.remove(path)
    os.rename(path + ".npy", path)


def _load_array(path) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:6] == b"\x93NUMPY":
        return np.load(_io.BytesIO(raw), allow_pickle=False)
    # a reference param file: one raw LoDTensor stream (lod_tensor.cc:246)
    from .inference.proto_import import parse_lod_tensor

    return parse_lod_tensor(raw)


def _put(scope, name, arr):
    scope.var(name)
    scope._set(name, torch.from_numpy(np.array(arr)))


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """reference io.py:94. A var with no value in the scope is left
    out."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    if filename is None:
        for var in vars:
            val = scope._get(var.name)
            if val is None:
                continue
            _save_array(os.path.join(dirname, var.name), _host_array(val))
        return
    blob = {}
    for var in vars:
        val = scope._get(var.name)
        if val is not None:
            blob[var.name] = _host_array(val)
    np.savez(os.path.join(dirname, filename), **blob)
    src = os.path.join(dirname, filename) + ".npz"
    dst = os.path.join(dirname, filename)
    if os.path.exists(src):
        if os.path.exists(dst):
            os.remove(dst)
        os.rename(src, dst)


def save_params(executor, dirname, main_program=None, filename=None):
    main_program = main_program or default_main_program()
    return save_vars(executor, dirname, main_program,
                     vars=main_program.all_parameters(), filename=filename)


def save_persistables(executor, dirname, main_program=None,
                      filename=None):
    """reference io.py:443."""
    main_program = main_program or default_main_program()
    return save_vars(executor, dirname, main_program,
                     vars=get_program_persistable_vars(main_program),
                     filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """reference io.py:493. Per-var files: a var whose file is missing
    is skipped. A combined file: ``.npy``/``.npz``, or the reference's
    concatenated LoDTensor streams in sorted-name order, which must hold
    exactly one tensor a var."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    if filename is None:
        for var in vars:
            path = os.path.join(dirname, var.name)
            if not os.path.exists(path):
                continue
            _put(scope, var.name, _load_array(path))
        return
    with open(os.path.join(dirname, filename), "rb") as f:
        raw = f.read()
    if raw[:6] == b"\x93NUMPY" or raw[:2] == b"PK":
        blob = np.load(_io.BytesIO(raw), allow_pickle=False)
        for var in vars:
            if var.name in blob:
                _put(scope, var.name, blob[var.name])
        return
    # the reference's combined layout (save_combine_op): its save and
    # load both walk the names sorted (reference io.py:203, :602)
    from .inference.proto_import import parse_lod_tensors_concat

    arrays = parse_lod_tensors_concat(raw)
    if len(arrays) != len(vars):
        raise ValueError(
            f"combined params file holds {len(arrays)} tensors but the "
            f"program lists {len(vars)} persistables")
    for var, arr in zip(sorted(vars, key=lambda v: v.name), arrays):
        _put(scope, var.name, arr)


def load_params(executor, dirname, main_program=None, filename=None):
    main_program = main_program or default_main_program()
    return load_vars(executor, dirname, main_program,
                     vars=main_program.all_parameters(), filename=filename)


def load_persistables(executor, dirname, main_program=None,
                      filename=None):
    """reference io.py:660."""
    main_program = main_program or default_main_program()
    return load_vars(executor, dirname, main_program,
                     vars=get_program_persistable_vars(main_program),
                     filename=filename)


def save_inference_model(dirname, feeded_var_names: List[str],
                         target_vars: List[Variable], executor,
                         main_program=None, model_filename=None,
                         params_filename=None,
                         export_for_deployment=True):
    """reference io.py:865: a test clone of the program pruned to the
    fetch targets, written as ``__model__`` (JSON) beside its
    persistables. Returns the fetch names."""
    main_program = main_program or default_main_program()
    target_names = [v.name for v in target_vars]
    pruned = main_program.clone(for_test=True)._prune(target_names)
    os.makedirs(dirname, exist_ok=True)
    model = {"program": pruned.to_dict(),
             "feed_names": list(feeded_var_names),
             "fetch_names": target_names}
    with open(os.path.join(dirname, model_filename or _MODEL_FILE),
              "w") as f:
        json.dump(model, f, default=_canon)
    save_vars(executor, dirname, pruned,
              vars=[v for v in pruned.list_vars() if _is_persistable(v)],
              filename=params_filename)
    return target_names


def _read_model(path) -> dict:
    """The model dict (program, feed and fetch names) of a ``__model__``
    in any of the three forms."""
    with open(path, "rb") as f:
        raw = f.read()
    from .native import ptpf

    if ptpf.is_ptpf(raw):
        with open(path + ".meta") as f:
            model = json.load(f)
        if "program" not in model:
            model["program"] = ptpf.from_bytes(raw)
        return model
    try:
        return json.loads(raw.decode())
    except (UnicodeDecodeError, ValueError):
        pass
    # a reference-saved __model__: a protobuf ProgramDesc
    from .inference import proto_import as _PI

    if not _PI.is_program_desc(raw):
        raise ValueError(
            f"'{path}' is neither a PTPF/JSON model nor a reference "
            f"protobuf ProgramDesc")
    program = _PI.parse_program_desc(raw)
    feeds, fetches = _PI.feed_fetch_names(program)
    return {"program": program.to_dict(), "feed_names": feeds,
            "fetch_names": fetches}


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """reference io.py:1020 -> (program, feed_names, fetch_targets); the
    persistables land in the global scope."""
    model = _read_model(os.path.join(dirname,
                                     model_filename or _MODEL_FILE))
    program = Program.from_dict(model["program"])
    persist = [v for v in program.list_vars() if _is_persistable(v)
               and v.type in (VarType.LOD_TENSOR, VarType.SELECTED_ROWS)]
    load_vars(executor, dirname, program, vars=persist,
              filename=params_filename)
    fetch_targets = [program.global_block.var(n)
                     for n in model["fetch_names"]]
    return program, model["feed_names"], fetch_targets
