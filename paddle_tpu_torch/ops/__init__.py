"""Op kernels; importing this package registers every op."""
from . import (control_flow_ops, math_ops, nn_ops,  # noqa: F401
               optimizer_ops, paged_ops, tensor_ops)
