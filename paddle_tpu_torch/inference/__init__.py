"""Inference of the port: the predictor over an exported model and the
serving front ends. The JAX package's ``export.py`` (StableHLO through
``jax.export``) has no counterpart here (ROADMAP A6)."""
from .config import AnalysisConfig, NativeConfig, PaddleDType  # noqa: F401
from .predictor import (AnalysisPredictor, PaddlePredictor,  # noqa: F401
                        PaddleTensor, ZeroCopyTensor,
                        create_paddle_predictor)
from .serving import (AdmissionInfeasible,  # noqa: F401
                      BlockPoolExhausted, ContinuousGenerationServer,
                      DeadlineExceeded, DisaggregatedPrefillWorker,
                      GenerationServer, InferenceServer,
                      PagedBeamDecoder, PagedContinuousGenerationServer,
                      RequestCancelled, ServerClosed, ServerQuiesced,
                      StreamingReply, apply_eos_sentinel, count_generated_tokens,
                      default_batch_buckets)
from .spec_controller import SpecController  # noqa: F401
