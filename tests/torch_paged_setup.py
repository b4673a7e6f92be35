"""Shared set-up of the port's continuous-batching tests
(tests/test_torch_paged.py, tests/test_torch_continuous.py): one small
Transformer configuration, its weights and prompts from seeded numpy,
fixed up front.

With these weights the greedy decodes of ``prompts(5, 12)`` have mixed
lengths: rows 0, 2, 5, 7, 8 and 10 run to the end of the 32-token
buffer (four blocks of 8), the others stop on end_id after 8 to 17
tokens (``LENGTHS``; the tests check them before they rely on them).
"""
import numpy as np

MODEL = dict(seq_len=12, max_out_len=32, d_model=32, n_heads=2,
             n_layers=1, d_inner=64, vocab=32, start_id=2, end_id=1)
BS = 8
LENGTHS = [31, 17, 31, 13, 8, 31, 8, 31, 31, 16, 31, 16]
LONG_ROWS = [0, 2, 5, 7, 8, 10]
WEIGHT_SEED = 2


def weights(startup, seed=WEIGHT_SEED):
    """Every persistable of `startup` from seeded numpy: matrices
    N(0, 1/fan_in), layer-norm scales 1 + N(0, 0.01), the other vectors
    N(0, 0.01)."""
    rng = np.random.RandomState(seed)
    out = {}
    for v in sorted(startup.global_block.vars.values(),
                    key=lambda v: v.name):
        if not v.persistable:
            continue
        shape = tuple(v.shape)
        if len(shape) == 2:
            a = rng.randn(*shape) / np.sqrt(shape[0])
        elif v.name.endswith("_ln.w"):
            a = 1 + 0.1 * rng.randn(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        out[v.name] = a.astype("float32")
    return out


def prompts(seed, n):
    """n prompt rows of seq_len tokens in [3, vocab)."""
    return np.random.RandomState(seed).randint(
        3, MODEL["vocab"], (n, MODEL["seq_len"])).astype(np.int64)


def jax_scope(params):
    """A JAX-package scope holding `params`."""
    import paddle_tpu as jf

    scope = jf.Scope()
    for name, arr in params.items():
        scope._set(name, arr)
    return scope


class PortModel:
    """The port's whole-loop decode program on the CPU with the seeded
    weights: the oracle every slot-pool run is held to."""

    def __init__(self):
        import paddle_tpu_torch as pf
        from paddle_tpu_torch import unique_name
        from paddle_tpu_torch.models import decode_engine as PD

        with unique_name.guard():
            self.main, startup, _, self.out = \
                PD.build_incremental_decode_program(**MODEL)
        self.params = weights(startup)
        self.scope = pf.Scope()
        pf.load_numpy_params(self.scope, self.params, pf.CPUPlace())
        self.exe = pf.Executor(pf.CPUPlace())

    def decode(self, srcs):
        """Sentinel-normalized whole-loop rows of `srcs`."""
        from paddle_tpu_torch.inference import serving as PS

        toks = self.exe.run(self.main, feed={"src_ids": srcs},
                            fetch_list=[self.out], scope=self.scope)[0]
        return PS.apply_eos_sentinel(toks, MODEL["end_id"])

    @staticmethod
    def bundle(n_slots, cache=None, **kw):
        from paddle_tpu_torch import unique_name
        from paddle_tpu_torch.models import decode_engine as PD

        with unique_name.guard():
            return PD.build_decode_step_program(
                n_slots=n_slots, cache=cache, **kw, **MODEL)


def paged_cache(n_blocks, n_entries, block_size=BS):
    from paddle_tpu_torch.models import decode_engine as PD

    return PD.CacheConfig(layout="paged", block_size=block_size,
                          n_blocks=n_blocks, n_prompt_entries=n_entries)


def sync_drive(srv, srcs):
    """Drive a server built with start=False on the calling thread
    (plan, fail, cycle), so pause and preemption dynamics do not depend
    on thread interleaving. Returns the replies."""
    from paddle_tpu_torch.inference import serving as PS

    replies = []
    for s in srcs:
        req = PS._GenRequest(np.asarray(s)[None].astype(np.int64),
                             PS.GenerationReply())
        srv._queue.append(req)
        replies.append(req.reply)
    for _ in range(500):
        if not (srv._queue or any(l is not None for l in srv._lanes)):
            return replies
        failures = []
        with srv._cv:
            admits = srv._plan_admissions_locked(failures)
            n, m, run = srv._plan_burst_locked(admits, not srv._queue,
                                               failures)
        srv._fail_requests(failures)
        if run:
            srv._cycle(admits, n, m)
    raise AssertionError("the scheduler failed to converge")
