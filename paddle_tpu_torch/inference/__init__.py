"""Serving front ends of the port."""
from .serving import (BlockPoolExhausted,  # noqa: F401
                      ContinuousGenerationServer, DeadlineExceeded,
                      GenerationServer, InferenceServer,
                      PagedContinuousGenerationServer, RequestCancelled,
                      ServerClosed, ServerQuiesced, apply_eos_sentinel,
                      count_generated_tokens)
