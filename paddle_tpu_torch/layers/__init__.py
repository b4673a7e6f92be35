"""The layers API of the port (reference python/paddle/fluid/layers)."""
from .control_flow import *  # noqa: F401,F403
from .io import data  # noqa: F401
from .learning_rate_scheduler import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from . import (control_flow, io, learning_rate_scheduler,  # noqa: F401
               metric_op, nn, ops, rnn, tensor)
