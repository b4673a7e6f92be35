"""Hand-written CUDA kernels for the port's hot paths, with their plain
PyTorch versions (counterpart of ``paddle_tpu/ops/pallas/``).

Every wrapper dispatches on the device of the tensors it is given:

* ``cuda``: it launches its kernel, or raises on an input the kernel
  does not take. It never gives way to the plain version.
* ``cpu``: it runs the plain version, the same function in PyTorch.
* ``meta``: it returns empty outputs of the right shape (build-time
  shape inference); nothing is launched.

Each wrapper carries a plain integer ``launches`` attribute that it
bumps once per kernel launch (``count_launch``, under a lock: a serving
thread and a prefill worker's thread launch the same kernels), so a run
can show that its path went through the kernels; the layer_norm,
sdpa_short and flash_attention wrappers also count their bf16 launches
apart (``launches_bf16``).
"""
import threading

import torch

_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, bf16: bool = False) -> None:
    """One launch of `wrapper`'s kernel (and of its bf16 instance when
    `bf16`): a read-modify-write of the wrapper's counters that two
    threads cannot interleave."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if bf16:
            wrapper.launches_bf16 += 1


def causal_keep(tq, tk, device):
    """The bottom-right aligned causal mask [tq, tk]: query i sees keys
    <= i + tk - tq."""
    return torch.ones((tq, tk), dtype=torch.bool, device=device).tril(tk - tq)


def masked_logits(q, k, scale, causal):
    """fp32 scores [B,H,tq,tk] of q,k [B,H,T,D]; a key hidden by the
    causal mask scores finfo.min (not -inf), so a row that sees no key
    gets a uniform distribution instead of NaN."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = causal_keep(*logits.shape[-2:], logits.device)
        logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    return logits


def reference_attention(q, k, v, scale, causal):
    """Masked-softmax attention oracle: q,k,v [B,H,T,D] -> [B,H,T,D]
    (``paddle_tpu/ops/pallas/__init__.py`` reference_attention), with
    `masked_logits`' finfo.min masking."""
    weights = torch.softmax(masked_logits(q, k, scale, causal), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights,
                        v.float()).to(q.dtype)


def check_launch(name: str, err: int) -> None:
    """Raise when a kernel's C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def current_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_inputs(name, tensors, dtypes):
    """The checks every wrapper makes before a launch."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def require_block_inputs(name, tensors, fp32=()):
    """The fused-block kernels' (#10-#13) checks: `tensors` all fp32 or
    all bf16 (x's dtype, the first's), `fp32` (a saved P) fp32, each
    contiguous and on one device; bf16 ones (the products' operands: not
    a bias) 16-byte aligned, since the kernels stage bf16 rows in 16-byte
    copies only."""
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} is neither float32 nor "
                        f"bfloat16")
    if dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: bf16 inputs must start on a 16-byte "
                         f"boundary")
    for t in fp32:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype} of the saved P is "
                            f"not float32")
    require_cuda_inputs(name, tensors, (dtype,))
    require_cuda_inputs(name, (*tensors, *fp32), (dtype, torch.float32))


def on_card(fn, primal, *args):
    """A kernel wrapper's CUDA path. Under a vjp (grad mode on and an
    input tracked, as `torch.func.vjp` in the grad op makes it) the
    differentiable autograd.Function `fn`, whose forward writes the
    residual its backward reads; else the primal launch
    ``primal(*args, False)``, which writes none (the Executor's forward
    op runs under `no_grad`)."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return fn.apply(*args)[0]
    return primal(*args, False)


def storage_tensor(t):
    """`t` with torch.func's wrappers taken off: the tensor whose data a
    kernel can be pointed at. An autograd.Function's saved tensors reach
    its backward wrapped when the Function runs under ``torch.func.vjp``
    (the grad ops' derivation), and a wrapper has no storage, so a
    backward that launches a kernel takes its inputs through this."""
    from torch._C import _functorch

    while _functorch.is_functorch_wrapped_tensor(t):
        t = _functorch.get_unwrapped(t)
    return t
