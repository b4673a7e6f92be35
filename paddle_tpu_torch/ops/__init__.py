"""Op kernels; importing this package registers every op."""
from . import (control_flow_ops, math_ops, misc_ops,  # noqa: F401
               nn_ops, optimizer_ops, paged_ops, spec_ops, tensor_ops)
