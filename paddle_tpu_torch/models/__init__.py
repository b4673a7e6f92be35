"""Models of the port."""
from .decode_engine import (CacheConfig, DecodeStepBundle,  # noqa: F401
                            SamplingConfig)
