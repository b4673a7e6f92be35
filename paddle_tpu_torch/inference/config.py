"""Predictor configuration (the port's counterpart of
``paddle_tpu/inference/config.py``; reference
inference/api/paddle_analysis_config.h + paddle_pass_builder.cc).

The JAX package's ``use_tpu`` becomes ``use_gpu``: a predictor runs on
the card (``CUDAPlace(0)``) unless ``disable_gpu()`` asks for the host,
as every entry point of the port does. ``enable_tpu_bf16()`` keeps its
name and means bf16 on the card."""
from __future__ import annotations

import enum
from typing import List, Optional


class PaddleDType(enum.Enum):
    FLOAT32 = "float32"
    BFLOAT16 = "bfloat16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"


# Default pass pipeline (reference api/paddle_pass_builder.cc builds the
# GpuPassStrategy/CpuPassStrategy lists). The JAX package's list, under
# its name, so that both packages analyse a model the same way.
TPU_PASSES: List[str] = [
    "dropout_eliminate_pass",
    "conv_bn_fuse_pass",
    "fc_fuse_pass",
]


class NativeConfig:
    """Minimal config (reference api/paddle_api.h NativeConfig): load +
    run, no IR optimization."""

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self.use_gpu = True

    def disable_gpu(self):
        """Run the predictor on the host (``CPUPlace``)."""
        self.use_gpu = False


class AnalysisConfig(NativeConfig):
    """reference api/paddle_analysis_config.h AnalysisConfig."""

    class Precision(enum.Enum):
        Float32 = "float32"
        Bfloat16 = "bfloat16"
        # reference has Int8 for TRT; kept for surface parity
        Int8 = "int8"

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        super().__init__(model_dir, prog_file, params_file)
        self._ir_optim = True
        self._passes: List[str] = list(TPU_PASSES)
        self._precision = AnalysisConfig.Precision.Float32
        self._memory_optim = True
        self._use_feed_fetch_ops = False
        self._specify_input_name = True
        self._profile = False
        self._serving: Optional[dict] = None

    # --- model location ------------------------------------------------
    def set_model(self, x: str, y: Optional[str] = None):
        if y is None:
            self.model_dir = x
        else:
            self.prog_file, self.params_file = x, y

    def set_prog_file(self, f: str):
        self.prog_file = f

    def set_params_file(self, f: str):
        self.params_file = f

    # --- optimization knobs --------------------------------------------
    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = flag

    def ir_optim(self) -> bool:
        return self._ir_optim

    def enable_memory_optim(self, flag: bool = True):
        # the Executor already frees each value after its last reader;
        # the knob is kept for parity
        self._memory_optim = flag

    def switch_use_feed_fetch_ops(self, flag: bool = False):
        self._use_feed_fetch_ops = flag

    def switch_specify_input_names(self, flag: bool = True):
        self._specify_input_name = flag

    def enable_profile(self):
        self._profile = True

    def pass_builder(self) -> "AnalysisConfig":
        return self

    def append_pass(self, name: str):
        self._passes.append(name)

    def delete_pass(self, name: str):
        self._passes = [p for p in self._passes if p != name]

    def all_passes(self) -> List[str]:
        return list(self._passes)

    # --- dynamic batching (inference/serving.py InferenceServer) -------
    def enable_dynamic_batching(self, max_batch_size: int = 8,
                                max_wait_ms: float = 2.0,
                                batch_buckets=None, seq_buckets=()):
        """Record serving defaults on the config: an InferenceServer
        built over a predictor carrying these knobs picks them up
        without per-callsite plumbing; explicit InferenceServer
        constructor arguments take precedence over the config's
        values."""
        self._serving = {
            "max_batch_size": int(max_batch_size),
            "max_wait_ms": float(max_wait_ms),
            "batch_buckets": (list(batch_buckets)
                              if batch_buckets is not None else None),
            "seq_buckets": list(seq_buckets),
        }

    def serving_options(self) -> Optional[dict]:
        return dict(self._serving) if self._serving else None

    # --- reduced precision (stands in for enable_tensorrt_engine) -----
    def enable_tpu_bf16(self):
        """Serve in bfloat16 on the card: the float32 params and the
        program's float32 constants are cast to bf16 once at load, float32
        feeds at each run, so activations flow in bf16 through the bf16
        kernels. Outputs are upcast to float32 for the caller."""
        self._precision = AnalysisConfig.Precision.Bfloat16

    def precision_mode(self):
        return self._precision

    def enable_tensorrt_engine(self, *a, **k):
        raise RuntimeError("TensorRT is not part of the port: the program "
                           "runs op by op through its own kernels (use "
                           "enable_tpu_bf16() for reduced precision)")
