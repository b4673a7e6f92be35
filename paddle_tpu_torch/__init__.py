"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package mirrors
its layout (core/, ops/, layers/, models/, inference/) so each module's
counterpart is easy to find, imports torch and never JAX, and runs its
hot paths through CUDA kernels written for Hopper (ops/kernels/).

    import paddle_tpu_torch as fluid
    exe = fluid.Executor()              # CUDAPlace(0); raises with no card
    exe = fluid.Executor(fluid.CPUPlace())  # host, plain versions

Training follows the reference's flow: build with ``layers``, call
``fluid.optimizer.Adam(...).minimize(loss)`` (append_backward, the
gradient clips of ``clip`` and the weight decay of ``regularizer``, then
the optimizer ops; ``optimizer.RecomputeOptimizer`` for activation
checkpointing), run the startup program, then ``exe.run(main, feed,
fetch_list)`` once per step, or ``exe.run_steps(main, feed, fetch_list,
steps=K)`` for K steps at once (on the card, one step captured in a CUDA
graph and replayed).

Serving an exported model follows the reference's deployment path:
``fluid.save_inference_model(dir, feeds, targets, exe, program)``, then
``inference.create_paddle_predictor(inference.AnalysisConfig(dir))`` (on
the card; ``config.disable_gpu()`` for the host) and ``predictor.run``,
or ``inference.InferenceServer(predictor)`` for batched serving.
Generation is served from a ``models.decode_engine`` decode-step bundle
by ``PagedContinuousGenerationServer`` (chat sessions and prefix reuse
over a ``RadixBlockTree``; chunked prefill, on the server or on a
``DisaggregatedPrefillWorker``; sampled emission under a
``SamplingConfig``; speculative decoding under a ``DraftConfig``, with
a ``SpecController`` over a ladder of draft lengths and a draft trained
on the target by ``distill_draft``) or decoded by ``PagedBeamDecoder``.

Observability follows ``FLAGS_observability`` (``off | metrics |
trace``; the environment variable, or ``fluid.set_flags``):
``observability.metrics.expose()`` is the Prometheus text of every
executor and server, ``observability.dump_trace(path)`` a chrome trace of
the requests' span trees, the PreparedProgram builds and the
``profiler``'s host events, ``observability.incident_report()`` the
flight recorder's cancelled, expired and failed requests.
"""
from . import ops  # noqa: F401  (registers every op)
from . import (backward, clip, layers, nets, optimizer,  # noqa: F401
               regularizer, unique_name)
from .core.executor import CPUPlace, CUDAPlace, Executor, seed  # noqa: F401
from .core.program import (Program, default_main_program,  # noqa: F401
                           default_startup_program, program_guard)
from .core.scope import (Scope, _reset_global_scope,  # noqa: F401
                         global_scope, scope_guard)
from . import analysis, inference, io, ir  # noqa: F401
from .inference import (DisaggregatedPrefillWorker,  # noqa: F401
                        PagedBeamDecoder, PagedContinuousGenerationServer)
from .models.decode_engine import (DraftConfig,  # noqa: F401
                                   RadixBlockTree, SamplingConfig)
from .models.distill import distill_draft  # noqa: F401
from .inference.spec_controller import SpecController  # noqa: F401
from .io import (load_inference_model, load_params,  # noqa: F401
                 load_persistables, load_vars, save_inference_model,
                 save_params, save_persistables, save_vars)
from .clip import (ErrorClipByValue, GradientClipByGlobalNorm,  # noqa: F401
                   GradientClipByNorm, GradientClipByValue,
                   set_gradient_clip)
from .param_attr import ParamAttr  # noqa: F401
from .regularizer import L1Decay, L2Decay  # noqa: F401
from .weights import load_numpy_params, scope_to_numpy  # noqa: F401
from . import flags, observability, profiler  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
