"""AnalysisPredictor: the port's serving path for an exported model
(counterpart of ``paddle_tpu/inference/predictor.py``; reference
inference/api/analysis_predictor.cc: Init :78, Run :192,
OptimizeInferenceProgram :417, ZeroCopyRun :567, and the
PaddlePredictor/PaddleTensor/ZeroCopyTensor API of api/paddle_api.h).

The predictor loads ``__model__`` and its params into a scope of its
own, runs the IR passes once, moves the params to the card once, and
then interprets the program op by op through the port's Executor, with
one PreparedProgram per feed spec (``PreparedCache``) and one
device-to-host copy per run.

bf16 (``AnalysisConfig.enable_tpu_bf16``): the float32 params, the
program's float32 constants and the float32 vars it declares become
bf16 once at load, float32 feeds are cast at each run (integer feeds
pass as they are), so the layer norm and attention ops reach their bf16
kernels; outputs come back as float32. The JAX package casts the params
and feeds only, so its float32 position table promotes a Transformer's
activations back to float32 after the embedding.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, List

import numpy as np
import torch

from ..core.executor import CPUPlace, CUDAPlace, Executor, PreparedCache
from ..core.scope import Scope, scope_guard
from ..core.types import DataType
from ..observability import tracing as obs_tracing
from .config import AnalysisConfig, NativeConfig, PaddleDType

# ops whose float32 output comes from an attr, cast with the params in
# bf16 mode
_CONSTANT_OPS = ("assign_value", "fill_constant")


class PaddleTensor:
    """Copy-in/copy-out tensor (reference api/paddle_api.h PaddleTensor)."""

    def __init__(self, data=None, name: str = "", lod=None, dtype=None):
        self.name = name
        self.data = np.asarray(data) if data is not None else None
        if dtype is not None and self.data is not None:
            self.data = self.data.astype(
                dtype.value if isinstance(dtype, PaddleDType) else dtype)
        self.lod = lod or []

    @property
    def shape(self):
        return list(self.data.shape) if self.data is not None else []

    @property
    def dtype(self):
        return PaddleDType(str(self.data.dtype)) if self.data is not None \
            else None

    def as_ndarray(self):
        return self.data


class ZeroCopyTensor:
    """Handle to a predictor-owned buffer (reference ZeroCopyTensor:
    copy_from_cpu/copy_to_cpu without an intermediate PaddleTensor)."""

    def __init__(self, predictor: "AnalysisPredictor", name: str,
                 is_input: bool):
        self._predictor = predictor
        self.name = name
        self._is_input = is_input

    def reshape(self, shape):
        pass  # shapes are taken from copy_from_cpu data

    def copy_from_cpu(self, arr: np.ndarray):
        if not self._is_input:
            raise RuntimeError(f"{self.name} is an output tensor")
        self._predictor._zero_copy_inputs[self.name] = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            return np.asarray(
                self._predictor._zero_copy_inputs[self.name])
        out = self._predictor._zero_copy_outputs.get(self.name)
        if out is None:
            raise RuntimeError("run the predictor before copy_to_cpu")
        return np.asarray(out)


class PaddlePredictor:
    """Minimal predictor interface (reference api/paddle_api.h)."""

    def run(self, inputs: List[PaddleTensor]) -> List[PaddleTensor]:
        raise NotImplementedError

    def clone(self) -> "PaddlePredictor":
        raise NotImplementedError


def _place(config: NativeConfig):
    """The card unless the config asks for the host. CUDAPlace raises
    with no card: a predictor never goes on quietly on the CPU."""
    return CUDAPlace(0) if config.use_gpu else CPUPlace()


def _bf16_mode(config) -> bool:
    return isinstance(config, AnalysisConfig) and (
        config.precision_mode() == AnalysisConfig.Precision.Bfloat16)


def _to_host(outs: List[torch.Tensor]) -> List[np.ndarray]:
    """The fetches as numpy, bf16 widened to float32, with one
    device-to-host copy for all of them: their bytes are packed into
    one buffer on the device first."""
    outs = [o.float() if o.dtype == torch.bfloat16 else o for o in outs]
    if not outs or outs[0].device.type == "cpu":
        return [o.numpy() for o in outs]
    flat = [o.contiguous().reshape(-1).view(torch.uint8) for o in outs]
    host = torch.cat(flat).cpu().numpy()
    res, off = [], 0
    for o, f in zip(outs, flat):
        n = f.numel()
        dt = np.dtype(str(o.dtype).replace("torch.", ""))
        res.append(host[off:off + n].view(dt).reshape(tuple(o.shape)))
        off += n
    return res


class AnalysisPredictor(PaddlePredictor):
    def __init__(self, config: NativeConfig):
        self._config = config
        self._scope = Scope()
        self._exe = Executor(_place(config))
        self._zero_copy_inputs: Dict[str, np.ndarray] = {}
        self._zero_copy_outputs: Dict[str, np.ndarray] = {}
        self._init()
        # the serving hot loop: one PreparedProgram per feed spec
        # (reference Executor::Prepare / RunPreparedContext)
        self._prepared = PreparedCache(
            self._exe, self._program, self._fetch_names, self._scope)

    # --- load + analyze (reference analysis_predictor.cc:78,417) -------
    def _init(self):
        from .. import io as fio

        cfg = self._config
        if cfg.model_dir is None and cfg.prog_file is None:
            raise ValueError("AnalysisConfig has no model location; call "
                             "set_model()")
        dirname = cfg.model_dir
        model_filename = params_filename = None
        if dirname is None:
            dirname = os.path.dirname(cfg.prog_file) or "."
            model_filename = os.path.relpath(cfg.prog_file, dirname)
            # params may live in a different directory than the program
            params_filename = (os.path.relpath(cfg.params_file, dirname)
                               if cfg.params_file else None)
        with scope_guard(self._scope):
            prog, feed_names, fetch_targets = fio.load_inference_model(
                dirname, self._exe, model_filename=model_filename,
                params_filename=params_filename)
        self._program = prog
        self._feed_names = list(feed_names)
        self._fetch_names = [v.name for v in fetch_targets]
        if isinstance(cfg, AnalysisConfig) and cfg.ir_optim():
            self._optimize_inference_program()
        if _bf16_mode(cfg):
            self._cast_bf16()
        # the params cross to the device once, here: a clone shares
        # these tensors and never copies them again
        for name in self._scope.local_var_names():
            v = self._scope._get(name)
            if v is not None:
                self._scope._set(name, v.to(self._exe.device))

    def _optimize_inference_program(self):
        from .. import ir

        ir.apply_passes(self._program, self._config.all_passes(),
                        scope=self._scope,
                        protected=set(self._fetch_names))

    def _cast_bf16(self):
        """The float32 params, constants and var declarations to bf16,
        once (the feed vars' too, so the Executor keeps bf16 feeds)."""
        for name in self._scope.local_var_names():
            v = self._scope._get(name)
            if v is not None and v.dtype == torch.float32:
                self._scope._set(name, v.to(torch.bfloat16))
        for blk in self._program.blocks:
            for var in blk.vars.values():
                if var.dtype == DataType.FP32:
                    var.dtype = DataType.BF16
            for op in blk.ops:
                if op.type in _CONSTANT_OPS \
                        and op.attrs.get("dtype") in ("float32", "float"):
                    op.attrs["dtype"] = "bfloat16"
        self._program._version += 1

    # --- introspection --------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_tensor(self, name: str) -> ZeroCopyTensor:
        if name not in self._feed_names:
            raise KeyError(f"{name!r} is not an input; inputs are "
                           f"{self._feed_names}")
        return ZeroCopyTensor(self, name, is_input=True)

    def get_output_tensor(self, name: str) -> ZeroCopyTensor:
        if name not in self._fetch_names:
            raise KeyError(f"{name!r} is not an output; outputs are "
                           f"{self._fetch_names}")
        return ZeroCopyTensor(self, name, is_input=False)

    get_input_handle = get_input_tensor
    get_output_handle = get_output_tensor

    def program(self):
        return self._program

    def fingerprint(self) -> str:
        """Content identity of the loaded (analyzed) program:
        ``Program.fingerprint()``, never the process-local ``_uid``."""
        return self._program.fingerprint()

    # --- execution ------------------------------------------------------
    def _run_feed(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        if _bf16_mode(self._config):
            feed = {k: (torch.as_tensor(v).to(torch.bfloat16)
                        if np.asarray(v).dtype == np.float32 else v)
                    for k, v in feed.items()}
        # the execute and readback spans attach to every request of the
        # batch a server parked in the ambient context (one thread-local
        # read when none is); execute_span names the cache tier from the
        # executor's build counter, the prepared lookup's miss included
        with obs_tracing.execute_span(self._exe, program=self._program,
                                      feed=feed):
            prepared = self._prepared.lookup(feed)
            outs = prepared.run(feed, return_numpy=False)
        with obs_tracing.span("readback"):
            return _to_host(outs)

    def run(self, inputs: List[PaddleTensor]) -> List[PaddleTensor]:
        """Copy-in/copy-out path (reference AnalysisPredictor::Run:192)."""
        feed = {}
        for i, t in enumerate(inputs):
            name = t.name if t.name else self._feed_names[i]
            feed[name] = t.data
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError(f"missing inputs: {missing}")
        outs = self._run_feed(feed)
        return [PaddleTensor(o, name=n)
                for n, o in zip(self._fetch_names, outs)]

    def zero_copy_run(self):
        """reference AnalysisPredictor::ZeroCopyRun:567."""
        missing = [n for n in self._feed_names
                   if n not in self._zero_copy_inputs]
        if missing:
            raise ValueError(f"copy_from_cpu not called for: {missing}")
        outs = self._run_feed(dict(self._zero_copy_inputs))
        self._zero_copy_outputs = dict(zip(self._fetch_names, outs))

    run_zero_copy = zero_copy_run

    def clone(self, share_cache: bool = True,
              cache=None) -> "AnalysisPredictor":
        """A predictor over the already-loaded program (reference
        AnalysisPredictor::Clone), with no disk read: the config is
        deep-copied, the scope is new and holds the same tensors (already
        on the device, so nothing is copied again).

        share_cache=True (the serving default) also shares the program
        object and the executor's program cache; a pass applied to the
        shared program later bumps its `_version`, which every sharer's
        cache keys on. share_cache=False gives an isolated clone: the
        program cloned under a fresh `_uid`, a private cache. `cache` (a
        dict) attaches the clone to an external program cache and
        implies sharing the program object."""
        twin = AnalysisPredictor.__new__(AnalysisPredictor)
        twin._config = copy.deepcopy(self._config)
        twin._scope = Scope()
        for name in self._scope.local_var_names():
            twin._scope._set(name, self._scope._get(name))
        twin._zero_copy_inputs = {}
        twin._zero_copy_outputs = {}
        place = self._exe.place
        if share_cache or cache is not None:
            twin._exe = Executor(place, cache=cache if cache is not None
                                 else self._exe._cache)
            twin._program = self._program
        else:
            twin._exe = Executor(place)
            twin._program = self._program.clone()
        twin._feed_names = list(self._feed_names)
        twin._fetch_names = list(self._fetch_names)
        twin._prepared = PreparedCache(
            twin._exe, twin._program, twin._fetch_names, twin._scope)
        return twin


def create_paddle_predictor(config: NativeConfig) -> AnalysisPredictor:
    """reference CreatePaddlePredictor<AnalysisConfig>
    (analysis_predictor.cc:832). Raises with no card unless the config
    calls ``disable_gpu()``."""
    return AnalysisPredictor(config)
