"""Models of the port."""
from .decode_engine import (CacheConfig, DecodeStepBundle,  # noqa: F401
                            DraftConfig, SamplingConfig)
from .distill import build_distill_program, distill_draft  # noqa: F401
