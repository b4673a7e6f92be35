"""Static checks of the port (the port's subset of paddle_tpu/analysis):
the session-capacity predicate the paged server's preflights call."""
from .liveness import CapacityCheck, session_feasibility  # noqa: F401
