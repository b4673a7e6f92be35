"""Op kernels; importing this package registers every op."""
from . import (control_flow_ops, decode_ops, math_ops,  # noqa: F401
               misc_ops, nn_ops, optimizer_ops, paged_ops, spec_ops,
               tensor_ops)
