"""Draft distillation: train a speculative draft on the target's own
greedy outputs and softened logits (the port's copy of
``paddle_tpu/models/distill.py``).

The acceptance of a draft is its agreement with the target, not with
the data: a draft trained on task labels alone agrees with the target
at chance on the content tokens. So the draft learns the target:

    loss = hard_w * CE(d_logits, argmax t_logits)
         + (1 - hard_w) * T^2 * CE(d_logits / T, softmax(t_logits / T))

on teacher-forced streams of the target's own greedy decode. One program
runs the target's forward (test mode, its parameters read by name from
the serving scope) and the draft's; the teacher signals are
stop_gradient and the optimizer takes the draft's parameters only, so no
gradient reaches the target. Each round's inner steps run as one
``Executor.run_steps`` call (on the card, a captured CUDA graph).

One difference from the JAX package: the draft's forward is built at
``draft.n_layers``. The JAX package builds both forwards at the target's
``n_layers``, which is the same program only when the two depths agree.
"""
import numpy as np

from .. import layers, optimizer
from ..core.program import Program, program_guard
from ..core.scope import Scope

__all__ = ["build_distill_program", "distill_draft"]


def build_distill_program(draft, *, seq_len, max_out_len, d_model,
                          n_heads, n_layers, d_inner, vocab,
                          temperature=2.0, hard_weight=0.5,
                          learning_rate=0.005):
    """The distillation program: the target's teacher-forced forward
    (softened probabilities and greedy labels, both stop_gradient) and
    the draft's (``draft.prefix``-named parameters) trained against
    both by Adam. Returns ``(main, startup, loss, agree)``; ``agree`` is
    the batch's argmax agreement, the in-program proxy of greedy
    acceptance. Feeds: ``src_ids`` [B, seq_len] and ``tgt_ids`` [B,
    max_out_len] (the target's greedy stream behind ``start_id``)."""
    from . import transformer as T

    if draft.kind != "model":
        raise ValueError("distillation needs a model draft "
                         f"(draft.kind={draft.kind!r})")
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data("src_ids", shape=[seq_len], dtype="int64")
        tgt = layers.data("tgt_ids", shape=[max_out_len], dtype="int64")

        def _forward(p, dm, nh, nl, dinner):
            max_len = max(seq_len, max_out_len)
            enc = T._embed(src, vocab, dm, max_len, 0.0, True,
                           f"{p}src_word_emb")
            for li in range(nl):
                enc = T.encoder_layer(enc, dm, nh, dinner, 0.0, True,
                                      name=f"{p}enc{li}")
            dec = T._embed(tgt, vocab, dm, max_len, 0.0, True,
                           f"{p}tgt_word_emb")
            for li in range(nl):
                dec = T.decoder_layer(dec, enc, dm, nh, dinner, 0.0, True,
                                      name=f"{p}dec{li}")
            return layers.fc(dec, vocab, num_flatten_dims=2,
                             bias_attr=False, param_attr=f"{p}logits.w")

        t_logits = _forward("", d_model, n_heads, n_layers, d_inner)
        d_logits = _forward(draft.prefix, draft.d_model, draft.n_heads,
                            draft.n_layers, draft.d_inner)
        # the teacher signals are constants to the backward: no grad op
        # of the target is ever emitted
        t_soft = layers.softmax(
            layers.scale(t_logits, scale=1.0 / float(temperature)))
        t_soft.stop_gradient = True
        t_hard = layers.cast(layers.argmax(t_logits, axis=-1), "int64")
        t_hard.stop_gradient = True
        soft_ce = layers.softmax_with_cross_entropy(
            layers.scale(d_logits, scale=1.0 / float(temperature)),
            t_soft, soft_label=True)
        hard_ce = layers.softmax_with_cross_entropy(
            d_logits, layers.unsqueeze(t_hard, [2]))
        hw = float(hard_weight)
        # T^2 restores the soft term's gradient scale (Hinton et al.)
        loss = layers.mean(layers.elementwise_add(
            layers.scale(hard_ce, scale=hw),
            layers.scale(soft_ce,
                         scale=(1.0 - hw) * float(temperature) ** 2)))
        agree = layers.mean(layers.cast(
            layers.equal(layers.cast(
                layers.argmax(d_logits, axis=-1), "int64"), t_hard),
            "float32"))
        draft_params = [p for p in main.all_parameters()
                        if p.name.startswith(draft.prefix)]
        if not draft_params:
            raise ValueError(
                f"no params under draft prefix {draft.prefix!r}")
        optimizer.Adam(learning_rate=learning_rate).minimize(
            loss, parameter_list=draft_params)
    return main, startup, loss, agree


def distill_draft(executor, scope, draft, decode_fn, prompts_fn, *,
                  seq_len, max_out_len, d_model, n_heads, n_layers,
                  d_inner, vocab, start_id, end_id, rounds=20,
                  batch=8, inner_steps=4, temperature=2.0,
                  hard_weight=0.5, learning_rate=0.005, seed=0):
    """Distil the draft in the live serving scope: the target's
    parameters are read in place and the draft's updated in place, so
    the next server on this scope serves the distilled draft.

    ``decode_fn(srcs) -> [B, max_out_len]`` is the target's greedy
    decode (the whole-loop program or a server), ``prompts_fn(rng, n) ->
    [n, seq_len]`` draws training prompts. A round rolls out one teacher
    batch, then takes ``inner_steps`` Adam steps on it in one
    ``run_steps`` call. Returns ``{"agree", "loss"}`` (per round, the
    last inner step's) with ``agree_first``/``agree_last``,
    ``loss_first`` (the first round's first step, before any update) and
    ``loss_last``."""
    main, startup, loss, agree = build_distill_program(
        draft, seq_len=seq_len, max_out_len=max_out_len,
        d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        d_inner=d_inner, vocab=vocab, temperature=temperature,
        hard_weight=hard_weight, learning_rate=learning_rate)
    # the startup initializes every parameter the program declares, the
    # target's too: run it into a throwaway scope and copy over only
    # what the live scope lacks (the draft's Adam moments, typically)
    tmp = Scope()
    executor.run(startup, scope=tmp)
    for name in tmp.local_var_names():
        if scope.has(name):
            continue
        val = tmp._get(name)
        if val is not None:
            scope.var(name).get_tensor().set(val)
    rng = np.random.RandomState(seed)
    agree_traj, loss_traj = [], []
    loss_first = None
    for _ in range(int(rounds)):
        srcs = np.asarray(prompts_fn(rng, batch), np.int64)
        out = np.asarray(decode_fn(srcs), np.int64)
        # sentinel rows (-1 after EOS) teacher-force as end_id
        out = np.where(out < 0, end_id, out)
        tgt_in = np.concatenate(
            [np.full((len(srcs), 1), start_id, np.int64), out[:, :-1]],
            axis=1)
        fetched = executor.run_steps(
            main, feed={"src_ids": srcs, "tgt_ids": tgt_in},
            fetch_list=[loss, agree], steps=int(inner_steps), scope=scope)
        steps = np.asarray(fetched[0]).reshape(-1)
        if loss_first is None:
            loss_first = float(steps[0])
        loss_traj.append(float(steps[-1]))
        agree_traj.append(float(np.asarray(fetched[1]).reshape(-1)[-1]))
    return {"agree": agree_traj, "loss": loss_traj,
            "agree_first": agree_traj[0] if agree_traj else None,
            "agree_last": agree_traj[-1] if agree_traj else None,
            "loss_first": loss_first,
            "loss_last": loss_traj[-1] if loss_traj else None}
