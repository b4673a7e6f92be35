"""The decode engine: the port's subset of
paddle_tpu/models/decode_engine.py (reference
tests/unittests/dist_transformer.py:1498 fast_decode; the slot-pool and
paged serving discipline of Orca and vLLM).

* ``build_greedy_decode_program`` and ``build_beam_decode_program``
  build the JAX package's whole-loop fronts: an encoder pass, then a
  ``while`` loop that re-runs the causally masked decoder over the whole
  token buffer each step and emits the greedy token (with EOS freezing)
  or extends the beams (``beam_search``, the histories reordered by
  parent, ``beam_search_decode`` after the loop). No KV cache: the
  greedy one is the oracle of the incremental program.
* ``build_incremental_decode_program`` builds the same Program as the
  JAX package's builder of that name: an encoder pass, per-layer cross
  K/V, then a ``while`` loop that embeds one token, runs the cached
  decoder stack, and emits the greedy token with EOS freezing.
* ``build_decode_step_program`` builds the slot-pool bundle that the
  continuous servers (inference/serving.py) run: admission programs, a
  one-token step over every lane, and the fused serve programs (an
  admission followed by a decode-burst While), over a dense per-lane KV
  cache or a paged one (``CacheConfig``: a shared block pool per layer
  addressed through host-allocated block tables, and a refcounted pool
  of prompt entries for the cross K/V).
* ``HostBlockPool`` and ``PromptPrefixCache`` are the host allocators
  of the paged layout; the device only reads the tables they fill.
* ``RadixBlockTree`` shares the full blocks of decoded-token self-KV
  chains between the turns of a chat session, the branches of an
  n-best fan-out and identical plain prompts (the radix tier: the
  bundle's ``("radix", A)`` serves admit a lane over a shared chain
  and teacher-force the rest of its history).

Parameter names are the JAX package's explicit ones, so weights carry
over by name. One place differs on purpose: the paged step's
self-attention. The JAX package gathers a dense [R,H,maxT,Dh] view of
each lane's pages and runs the biased softmax over it; the port runs
one ``paged_decode_attention`` op a layer instead (kernel #9 on the
card), which computes the same function without the view.

The bundle also samples (``SamplingConfig``: temperature, top-k and
top-p lanes keyed on per-request seeds, with JAX's own threefry noise,
ops/spec_ops.py), prefills in chunks (``CacheConfig(chunk_tokens=C)``:
the ``("chunked", p)`` phase programs stream a prompt's encoder through
the prompt-entry pool C tokens a dispatch, fused with the decode burst)
and decodes speculatively (``DraftConfig``: a small draft model, or the
model-free n-gram proposer, proposes k tokens a lane, one k+1-query
target step verifies them through ``spec_accept``, and an optional
ladder of k values gives the host controller pre-built serves to choose
from). The verify step attends over the gathered dense view with a
plain matmul, as the JAX package's does; kernel #9 computes one query a
lane and serves the plain one-token step only. Tensor-parallel sharding
belongs to a later slice.

Every ``while`` of these programs runs on the interpreting executor: it
reads its condition back to the host once an iteration and is never
captured in a CUDA graph.
"""
from __future__ import annotations

import types
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import layers
from ..core.program import Program, program_guard
from ..observability import devtel
from ..ops.kernels import paged_attention as KPA
from ..param_attr import ParamAttr

# name mark of the shared pool persistables (the JAX package's checker
# PTA110 keys on it; the port keeps the names identical)
POOL_MARK = "@POOL"

# fixed-name whole-loop tick counter (observability/devtel.py in the JAX
# package): fetch it to read how many iterations the early exit allowed
DECODE_STEPS_VAR = "@decode_steps"


def declare_decode_steps(block):
    """A [1] int64 var named ``@decode_steps``, initialized to 0."""
    return layers.fill_constant(
        [1], "int64", 0,
        out=block.create_var(name=DECODE_STEPS_VAR, shape=(1,),
                             dtype="int64", stop_gradient=True))


def init_token_buffer(src, positions, max_out_len, start_id):
    """[B, maxT] int64 zeros with the start token at position 0."""
    buf = layers.fill_constant_batch_size_like(
        src, [-1, max_out_len], "int64", 0.0)
    if start_id:
        start_col = layers.cast(
            layers.equal(positions,
                         layers.fill_constant([1], "int64", 0.0)),
            "int64")
        buf = layers.elementwise_add(
            buf, layers.cast(
                layers.scale(start_col, scale=float(start_id)),
                "int64"))
    return layers.assign(buf)


def emit_token_step(src, step_logits_v, positions, tgt_buf, finished,
                    counter, limit, cond, max_out_len, end_id):
    """Greedy argmax, EOS freeze (finished rows keep emitting end_id),
    one-hot write at position t+1, counter bump, and the loop condition
    refresh: continue while steps remain AND a row is unfinished."""
    tok = layers.cast(layers.argmax(step_logits_v, axis=-1), "int64")
    not_fin = layers.elementwise_sub(
        layers.fill_constant_batch_size_like(
            src, [-1], "int64", 1.0), finished)
    tok = layers.elementwise_add(
        layers.elementwise_mul(tok, not_fin),
        layers.cast(layers.scale(finished, scale=float(end_id)),
                    "int64"))
    layers.assign(
        layers.elementwise_max(
            finished,
            layers.cast(layers.equal(
                tok, layers.fill_constant([1], "int64",
                                          float(end_id))), "int64")),
        output=finished)
    next_mask = layers.cast(
        layers.equal(positions,
                     layers.increment(counter, 1, in_place=False)),
        "int64")
    keep = layers.elementwise_sub(
        layers.fill_constant([max_out_len], "int64", 1.0), next_mask)
    layers.assign(
        layers.elementwise_add(
            layers.elementwise_mul(tgt_buf, keep),
            layers.elementwise_mul(layers.unsqueeze(tok, [1]),
                                   next_mask)),
        output=tgt_buf)
    layers.increment(counter, 1)
    unfinished = layers.reduce_sum(
        layers.elementwise_sub(
            layers.fill_constant_batch_size_like(
                src, [-1], "int64", 1.0), finished),
        keep_dim=True)
    layers.greater_than(
        layers.elementwise_min(
            layers.elementwise_sub(limit, counter), unfinished),
        layers.fill_constant([1], "int64", 0.0), cond=cond)


def step_logits(dec, positions, counter, vocab):
    """Step t's logits [rows, V]: the decoder's hidden row at t picked
    out (a one-hot sum over positions) before the vocab projection, so
    the product is [rows, D] x [D, V], not [rows, maxT, D] x [D, V]."""
    t_mask = layers.cast(layers.equal(positions, counter), "float32")
    step_hidden = layers.reduce_sum(
        layers.elementwise_mul(dec, layers.unsqueeze(t_mask, [1]),
                               axis=1), dim=1)
    return layers.fc(step_hidden, vocab, bias_attr=False,
                     param_attr="logits.w")


def _refuse_sharding(fn_name, sharding):
    if sharding is not None:
        raise NotImplementedError(
            f"{fn_name}(sharding=...): tensor-parallel programs are not "
            f"ported yet (ROADMAP Queue A item 10, A10: serving step 10, "
            f"ShardingConfig); build an unsharded program")


def heads_of(x, t, n_heads, head_dim):
    """[R,t,H*D] -> [R,H,t,D], the cached-attention head layout."""
    return layers.transpose(
        layers.reshape(x, [0, t, n_heads, head_dim]),
        perm=[0, 2, 1, 3])


class _DenseLaneCache:
    """Per-layer dense self-KV access: one-hot masked write into
    per-lane ``[R, H, maxT, Dh]`` vars; attention reads the vars."""

    def __init__(self, kc, vc, write_mask, keep_mask):
        self.kc, self.vc = kc, vc
        self.write_mask, self.keep_mask = write_mask, keep_mask

    def update(self, kh, vh):
        new_kc = layers.elementwise_add(
            layers.elementwise_mul(self.kc, self.keep_mask),
            layers.elementwise_mul(kh, self.write_mask))
        new_vc = layers.elementwise_add(
            layers.elementwise_mul(self.vc, self.keep_mask),
            layers.elementwise_mul(vh, self.write_mask))
        layers.assign(new_kc, output=self.kc)
        layers.assign(new_vc, output=self.vc)
        return self.kc, self.vc


class _PagedLaneCache:
    """Per-layer paged self-KV access. Writes go through
    ``masked_pool_write`` into the shared ``[NB, BS, H, Dh]`` pool at
    each lane's block-table cell, gated by the active mask so idle,
    dustbin and paused lanes never touch the pool.

    ``routed`` (decided by shape alone, ``paged_attention.usable``):
    ``update`` only writes, and ``cached_decoder_step`` attends with one
    ``paged_decode_attention`` op over the pools through ``block_tab``
    and ``step``. Otherwise ``update`` also gathers every lane's maxT
    positions back into the dense ``[R, H, maxT, Dh]`` view through
    ``flat_pos`` and the step attends over it as the JAX package does;
    cells a lane has not written hold stale pool values, which the
    validity bias masks exactly as the dense layout masks its zeros."""

    def __init__(self, pool_k, pool_v, write_idx, gate, rows, n_heads,
                 head_dim, maxT, n_cells, block_tab, step, flat_pos=None):
        self.pool_k, self.pool_v = pool_k, pool_v
        self.write_idx, self.gate = write_idx, gate
        self.rows, self.maxT = rows, maxT
        self.n_heads, self.head_dim = n_heads, head_dim
        self.n_cells = n_cells            # NB * BS
        self.block_tab, self.step = block_tab, step
        self.flat_pos = flat_pos          # [rows*maxT] int32, or None
        self.routed = flat_pos is None

    def _view(self, pool):
        flat = layers.reshape(pool, [self.n_cells,
                                     self.n_heads * self.head_dim])
        rows_kv = layers.gather(flat, self.flat_pos)
        return layers.transpose(
            layers.reshape(rows_kv, [self.rows, self.maxT,
                                     self.n_heads, self.head_dim]),
            perm=[0, 2, 1, 3])

    def write(self, kh, vh):
        for pool, new in ((self.pool_k, kh), (self.pool_v, vh)):
            layers.masked_pool_write(
                pool,
                layers.reshape(new, [0, self.n_heads, self.head_dim]),
                self.write_idx, gate=self.gate, leading_dims=2,
                exclusive_via="block_table")

    def update(self, kh, vh):
        self.write(kh, vh)
        return self._view(self.pool_k), self._view(self.pool_v)


class _DenseSpanCache:
    """Per-layer dense self-KV access for a multi-position write (the
    speculative verify step: q = k+1 query rows a lane land at cache
    positions t..t+k in one update). ``pos_oh`` is the [R,q,maxT]
    one-hot of each query's position (an all-zero row past the buffer
    writes nothing); the scatter is a one-hot matmul and the read view
    is the var itself, as in _DenseLaneCache."""

    def __init__(self, kc, vc, pos_oh, keep_mask):
        self.kc, self.vc = kc, vc
        # [R,1,maxT,q] scatter operand (matmul against [R,H,q,Dh])
        self.scat = layers.unsqueeze(
            layers.transpose(pos_oh, perm=[0, 2, 1]), [1])
        self.keep_mask = keep_mask  # [R,1,maxT,1]

    def update(self, kh, vh):
        for var, new in ((self.kc, kh), (self.vc, vh)):
            scat = layers.matmul(self.scat, new)  # [R,H,maxT,Dh]
            layers.assign(layers.elementwise_add(
                layers.elementwise_mul(var, self.keep_mask), scat),
                output=var)
        return self.kc, self.vc


class _PagedSpanCache(_PagedLaneCache):
    """Per-layer paged self-KV access for the multi-position verify
    write: the q positions of every lane flatten to R*q
    ``masked_pool_write`` rows (distinct cells: a lane's positions are
    distinct and lanes own disjoint blocks), with the gate extended by
    each position's validity, so a position past the buffer never
    touches the pool. Reads gather the dense [R,H,maxT,Dh] view, as an
    unrouted lane cache does."""

    def __init__(self, pool_k, pool_v, write_idx_rq, gate_rq, flat_pos,
                 rows, q, n_heads, head_dim, maxT, n_cells):
        # write_idx_rq and gate_rq: [R*q], a lane's q positions in turn
        super().__init__(pool_k, pool_v, write_idx_rq, gate_rq, rows,
                         n_heads, head_dim, maxT, n_cells, None, None,
                         flat_pos=flat_pos)
        self.q = q

    def update(self, kh, vh):
        for pool, new in ((self.pool_k, kh), (self.pool_v, vh)):
            # [R,H,q,Dh] -> [R*q, H, Dh] write rows
            rows_new = layers.reshape(
                layers.transpose(new, perm=[0, 2, 1, 3]),
                [self.rows * self.q, self.n_heads, self.head_dim])
            layers.masked_pool_write(
                pool, rows_new, self.write_idx, gate=self.gate,
                leading_dims=2, exclusive_via="block_table")
        return self._view(self.pool_k), self._view(self.pool_v)


def cached_decoder_step(x, caches, cross_kv, att_bias, d_model,
                        n_heads, d_inner, prefix="", q=1,
                        qkv_interleaved=False):
    """One KV-cached decoder-stack step over a [R,q,D] row batch
    (``decode_engine.py:659`` in the JAX package). ``caches``: per-layer
    cache-access objects (the lane caches for q = 1, the span caches for
    the speculative q = k+1 verify step); ``cross_kv``: per-layer (ck,
    cv) [R,H,S,Dh] encoder projections; ``att_bias``: the 0/-1e9
    validity bias added to the [R,H,q,maxT] scores, per query for q > 1
    ([R,1,q,maxT]: query j masks positions past t+j), None when every
    cache is a routed paged cache, which masks by its step (q = 1 only).
    ``prefix`` names a draft model's parameters. The head-interleaved
    fused qkv weight (``qkv_interleaved``) belongs to the tensor-parallel
    step and raises. Returns the [R,q,D] hidden rows after all layers."""
    from . import transformer as T

    if qkv_interleaved:
        raise NotImplementedError(
            "cached_decoder_step(qkv_interleaved=True): the "
            "head-interleaved fused qkv weight belongs to tensor-parallel "
            "bundles (serving step 10 of the port: ShardingConfig)")
    head_dim = d_model // n_heads
    scale = head_dim ** -0.5
    for li, cache in enumerate(caches):
        qkv = layers.fc(
            x, 3 * d_model, num_flatten_dims=2, bias_attr=False,
            param_attr=T._attn_proj_attr(f"{prefix}dec{li}_self",
                                         "qkv", d_model))
        qv, k, v = layers.split(qkv, 3, dim=2)
        qh = heads_of(qv, q, n_heads, head_dim)
        kh = heads_of(k, q, n_heads, head_dim)
        vh = heads_of(v, q, n_heads, head_dim)
        if getattr(cache, "routed", False) and q == 1:
            cache.write(kh, vh)
            ctx = layers.paged_decode_attention(
                qh, cache.pool_k, cache.pool_v, cache.block_tab,
                cache.step, scale=scale)
        else:
            kc, vc = cache.update(kh, vh)
            scores = layers.scale(
                layers.matmul(qh, kc, transpose_y=True), scale=scale)
            scores = layers.elementwise_add(scores, att_bias)
            probs = layers.softmax(scores, axis=-1)
            ctx = layers.matmul(probs, vc)
        ctx = layers.reshape(
            layers.transpose(ctx, perm=[0, 2, 1, 3]), [0, q, d_model])
        attn_out = layers.fc(ctx, d_model, num_flatten_dims=2,
                             bias_attr=False,
                             param_attr=f"{prefix}dec{li}_self_out.w")
        x = T._add_norm(attn_out, x, 0.0, True,
                        name=f"{prefix}dec{li}_a")
        q2 = layers.fc(
            x, d_model, num_flatten_dims=2, bias_attr=False,
            param_attr=T._attn_proj_attr(f"{prefix}dec{li}_cross",
                                         "q", d_model))
        q2h = heads_of(q2, q, n_heads, head_dim)
        ck, cv = cross_kv[li]
        s2 = layers.scale(
            layers.matmul(q2h, ck, transpose_y=True), scale=scale)
        p2 = layers.softmax(s2, axis=-1)
        ctx2 = layers.reshape(
            layers.transpose(layers.matmul(p2, cv), perm=[0, 2, 1, 3]),
            [0, q, d_model])
        cross_out = layers.fc(
            ctx2, d_model, num_flatten_dims=2, bias_attr=False,
            param_attr=f"{prefix}dec{li}_cross_out.w")
        x = T._add_norm(cross_out, x, 0.0, True,
                        name=f"{prefix}dec{li}_b")
        ffn = T._ffn(x, d_model, d_inner, 0.0, True,
                     name=f"{prefix}dec{li}")
        x = T._add_norm(ffn, x, 0.0, True, name=f"{prefix}dec{li}_c")
    return x


def build_greedy_decode_program(seq_len=16, max_out_len=16,
                                d_model=64, n_heads=4, n_layers=2,
                                d_inner=128, vocab=1000, start_id=0,
                                end_id=1, sharding=None):
    """Autoregressive greedy generation over the full decoder
    (decode_engine.py:767 in the JAX package; reference
    tests/unittests/dist_transformer.py:1498 fast_decode at beam 1): each
    step re-runs the causally masked decoder on the [B, max_out_len]
    token buffer and writes position t+1; positions past t are masked
    out, so no KV cache is needed. A row that emits end_id keeps
    emitting it, and the loop ends early once every row has.

    Weights are shared with a training program by their explicit names.
    `sharding` other than None raises NotImplementedError.
    Returns (program, startup, feeds, out_ids_var)."""
    from . import transformer as T

    _refuse_sharding("build_greedy_decode_program", sharding)
    main = Program()
    startup = Program()
    with program_guard(main, startup):
        src = layers.data("src_ids", shape=[seq_len], dtype="int64")
        enc = T._embed(src, vocab, d_model, max(seq_len, max_out_len),
                       0.0, True, "src_word_emb")
        for li in range(n_layers):
            enc = T.encoder_layer(enc, d_model, n_heads, d_inner, 0.0,
                                  is_test=True, name=f"enc{li}")
        positions = layers.cast(layers.range(0, max_out_len, 1), "int64")
        tgt_buf = init_token_buffer(src, positions, max_out_len, start_id)
        counter = declare_decode_steps(main.global_block)
        limit = layers.fill_constant([1], "int64", float(max_out_len - 1))
        finished = layers.assign(layers.fill_constant_batch_size_like(
            src, [-1], "int64", 0.0))
        cond = layers.less_than(counter, limit)
        w = layers.While(cond)
        with w.block():
            dec = T._embed(tgt_buf, vocab, d_model,
                           max(seq_len, max_out_len), 0.0, True,
                           "tgt_word_emb")
            for li in range(n_layers):
                dec = T.decoder_layer(dec, enc, d_model, n_heads, d_inner,
                                      0.0, is_test=True, name=f"dec{li}")
            logits_v = step_logits(dec, positions, counter, vocab)
            emit_token_step(src, logits_v, positions, tgt_buf, finished,
                            counter, limit, cond, max_out_len, end_id)
    return main, startup, ["src_ids"], tgt_buf


def build_beam_decode_program(seq_len=16, max_out_len=16, d_model=64,
                              n_heads=4, n_layers=2, d_inner=128,
                              vocab=1000, start_id=0, end_id=1,
                              beam_size=4, batch_size=1):
    """Batched beam-search generation (decode_engine.py:3253 in the JAX
    package; reference tests/unittests/dist_transformer.py:1523). Beams
    ride the batch axis at static [batch*beam, maxT] shapes, batch-major:
    every step runs the causally masked decoder over all rows, takes the
    top 2*beam tokens of each row's softmax, lets the beam_search op pick
    each source's beams (accumulated log-probs, EOS freezing), reorders
    each hypothesis' history by its absolute parent row and, after the
    loop, backtracks with beam_search_decode. Step 0 has one live beam a
    source (the others start at -1e9), or the beams would never split.

    Weights are shared by their explicit names. Returns (program,
    startup, feeds, (sentence_ids [T, batch*beam], sentence_scores
    [batch*beam]))."""
    from . import transformer as T

    maxT = max_out_len
    rows = batch_size * beam_size
    main = Program()
    startup = Program()
    with program_guard(main, startup):
        src = layers.data("src_ids", shape=[batch_size, seq_len],
                          dtype="int64", append_batch_size=False)
        enc1 = T._embed(src, vocab, d_model, max(seq_len, maxT), 0.0,
                        True, "src_word_emb")
        for li in range(n_layers):
            enc1 = T.encoder_layer(enc1, d_model, n_heads, d_inner, 0.0,
                                   is_test=True, name=f"enc{li}")
        # each source's encoding beam_size times, batch-major rows
        enc = layers.reshape(
            layers.expand(layers.unsqueeze(enc1, [1]),
                          [1, beam_size, 1, 1]),
            [rows, seq_len, d_model])
        positions = layers.cast(layers.range(0, maxT, 1), "int64")
        tgt_buf = layers.assign(layers.fill_constant(
            [rows, maxT], "int64", 0.0))
        if start_id:
            start_col = layers.cast(
                layers.equal(positions,
                             layers.fill_constant([1], "int64", 0.0)),
                "int64")
            tgt_buf = layers.assign(layers.elementwise_add(
                tgt_buf, layers.cast(
                    layers.scale(start_col, scale=float(start_id)),
                    "int64")))
        pre_ids = layers.assign(layers.fill_constant(
            [rows, 1], "int64", float(start_id)))
        pre_scores = layers.assign(np.where(
            np.arange(rows) % beam_size == 0, 0.0,
            -1e9).astype("float32").reshape(rows, 1))
        # the step buffers of the backtrack, [maxT, rows, 1]
        ids_buf = layers.assign(layers.fill_constant(
            [maxT, rows, 1], "int64", float(end_id)))
        scores_buf = layers.assign(layers.fill_constant(
            [maxT, rows, 1], "float32", 0.0))
        parents_buf = layers.assign(layers.fill_constant(
            [maxT, rows, 1], "int64", 0.0))
        zero = layers.fill_constant([1], "int64", 0)
        ids_buf = layers.assign(layers.scatter(
            ids_buf, zero, layers.reshape(pre_ids, [1, rows, 1])))
        counter = layers.fill_constant([1], "int64", 0)
        limit = layers.fill_constant([1], "int64", float(maxT - 1))
        cond = layers.less_than(counter, limit)
        w = layers.While(cond)
        with w.block():
            dec = T._embed(tgt_buf, vocab, d_model, max(seq_len, maxT),
                           0.0, True, "tgt_word_emb")
            for li in range(n_layers):
                dec = T.decoder_layer(dec, enc, d_model, n_heads, d_inner,
                                      0.0, is_test=True, name=f"dec{li}")
            logits_v = step_logits(dec, positions, counter, vocab)
            probs = layers.softmax(logits_v)
            topk_scores, topk_ids = layers.topk(
                probs, min(2 * beam_size, vocab))
            acc = layers.elementwise_add(layers.log(topk_scores),
                                         pre_scores)
            sel_ids, sel_scores, parent = layers.beam_search(
                pre_ids, pre_scores, topk_ids, acc, beam_size=beam_size,
                end_id=end_id, return_parent_idx=True)
            parent_flat = layers.reshape(parent, shape=[rows])
            # each surviving hypothesis inherits its parent's history
            layers.assign(layers.gather(tgt_buf, parent_flat),
                          output=tgt_buf)
            layers.increment(counter, 1)
            next_mask = layers.cast(layers.equal(positions, counter),
                                    "int64")
            keep = layers.elementwise_sub(
                layers.fill_constant([maxT], "int64", 1.0), next_mask)
            layers.assign(layers.elementwise_add(
                layers.elementwise_mul(tgt_buf, keep),
                layers.elementwise_mul(
                    layers.reshape(sel_ids, [rows, 1]), next_mask)),
                output=tgt_buf)
            for buf, val in ((ids_buf, sel_ids), (scores_buf, sel_scores),
                             (parents_buf, parent)):
                layers.assign(layers.scatter(
                    buf, counter, layers.reshape(val, [1, rows, 1])),
                    output=buf)
            layers.assign(layers.reshape(sel_ids, [rows, 1]),
                          output=pre_ids)
            layers.assign(layers.reshape(sel_scores, [rows, 1]),
                          output=pre_scores)
            layers.less_than(counter, limit, cond=cond)
        out_ids, out_scores = layers.beam_search_decode(
            ids_buf, scores_buf, beam_size=beam_size, end_id=end_id,
            parents=parents_buf)
    return main, startup, ["src_ids"], (out_ids, out_scores)


def build_incremental_decode_program(seq_len=16, max_out_len=16,
                                     d_model=64, n_heads=4,
                                     n_layers=2, d_inner=128,
                                     vocab=1000, start_id=0,
                                     end_id=1):
    """KV-cached autoregressive greedy generation
    (decode_engine.py:842 in the JAX package). Each loop step embeds
    ONE token and runs the decoder stack against cached self-attention
    K/V (written at position t) and precomputed cross-attention K/V.

    Returns (program, startup, feeds, out_ids_var)."""
    from . import transformer as T

    head_dim = d_model // n_heads
    maxT = max_out_len

    main = Program()
    startup = Program()
    with program_guard(main, startup):
        src = layers.data("src_ids", shape=[seq_len], dtype="int64")
        enc = T._embed(src, vocab, d_model, max(seq_len, maxT), 0.0,
                       True, "src_word_emb")
        for li in range(n_layers):
            enc = T.encoder_layer(enc, d_model, n_heads, d_inner, 0.0,
                                  is_test=True, name=f"enc{li}")

        cross_kv = []
        for li in range(n_layers):
            kv = layers.fc(enc, 2 * d_model, num_flatten_dims=2,
                           bias_attr=False,
                           param_attr=T._attn_proj_attr(
                               f"dec{li}_cross", "kv", d_model))
            k, v = layers.split(kv, 2, dim=2)
            cross_kv.append((heads_of(k, seq_len, n_heads, head_dim),
                             heads_of(v, seq_len, n_heads, head_dim)))

        positions = layers.cast(layers.range(0, maxT, 1), "int64")
        posf = layers.cast(positions, "float32")
        pos_table = layers.assign(
            T._position_encoding(max(seq_len, maxT), d_model)[:maxT])

        tgt_buf = init_token_buffer(src, positions, maxT, start_id)
        caches = []
        for li in range(n_layers):
            kc = layers.assign(layers.fill_constant_batch_size_like(
                src, [-1, n_heads, maxT, head_dim], "float32", 0.0))
            vc = layers.assign(layers.fill_constant_batch_size_like(
                src, [-1, n_heads, maxT, head_dim], "float32", 0.0))
            caches.append((kc, vc))
        counter = declare_decode_steps(main.global_block)
        limit = layers.fill_constant([1], "int64", float(maxT - 1))
        finished = layers.assign(layers.fill_constant_batch_size_like(
            src, [-1], "int64", 0.0))
        cond = layers.less_than(counter, limit)
        w = layers.While(cond)
        with w.block():
            t_mask = layers.cast(layers.equal(positions, counter),
                                 "float32")  # [maxT]
            cur_tok = layers.reduce_sum(
                layers.elementwise_mul(tgt_buf,
                                       layers.cast(t_mask, "int64")),
                dim=1, keep_dim=True)  # [B,1]
            x = layers.embedding(cur_tok, size=[vocab, d_model],
                                 param_attr=ParamAttr(
                                     name="tgt_word_emb"))
            # lookup_table squeezes the trailing 1 of [B,1] ids
            x = layers.unsqueeze(x, [1])
            x = layers.scale(x, scale=d_model ** 0.5)
            pos_t = layers.reduce_sum(
                layers.elementwise_mul(
                    pos_table, layers.unsqueeze(t_mask, [1]), axis=0),
                dim=0)  # [D]
            x = layers.elementwise_add(x, pos_t)  # [B,1,D]
            att_mask = layers.scale(
                layers.cast(layers.greater_than(
                    posf, layers.cast(counter, "float32")),
                    "float32"), scale=-1e9)  # [maxT] 0 keep / -1e9 drop
            m2 = layers.unsqueeze(t_mask, [1])  # [maxT,1]
            keepc = layers.unsqueeze(
                layers.elementwise_sub(
                    layers.fill_constant([maxT], "float32", 1.0),
                    t_mask), [1])
            cache_objs = [_DenseLaneCache(kc, vc, m2, keepc)
                          for kc, vc in caches]
            x = cached_decoder_step(x, cache_objs, cross_kv, att_mask,
                                    d_model, n_heads, d_inner)
            logits_v = layers.fc(
                layers.reshape(x, [0, d_model]), vocab,
                bias_attr=False, param_attr="logits.w")  # [B,V]
            emit_token_step(src, logits_v, positions, tgt_buf,
                            finished, counter, limit, cond, maxT,
                            end_id)
    return main, startup, ["src_ids"], tgt_buf


class ServingUnavailable(RuntimeError):
    """Base of the serving-layer rejection taxonomy
    (decode_engine.py:3393 in the JAX package): ``retryable`` says
    whether the same request may succeed later, ``retry_after_ms`` when
    a retry is worth attempting (None = no estimate)."""

    retryable = False
    retry_after_ms = None


class BlockPoolExhausted(ServingUnavailable):
    """The shared KV block pool (or the prompt-entry pool) cannot
    satisfy an allocation and nothing in flight can ever free one.
    Retryable: the caller may resubmit once other requests retire, or
    against a larger pool. Raised instead of hanging the scheduler;
    transient pressure queues or pauses lanes instead."""

    retryable = True
    retry_after_ms = 50.0


class AdmissionInfeasible(ServingUnavailable):
    """The serving configuration, not the load, can never admit the
    request. Not retryable."""

    retryable = False


class BlockLifetimeError(ValueError):
    """A host-allocator call broke the block lifetime ``free ->
    exclusive(lane) -> shared(refcount > 1) -> free``: freeing an
    unallocated or already-freed block, or releasing a zero-ref prompt
    entry. The state is left unchanged."""


# ---------------------------------------------------------------------------
# The slot-pool bundle (continuous batching), dense or paged.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CacheConfig:
    """KV cache layout of a slot-pool decode bundle
    (``decode_engine.py:154`` in the JAX package).

    ``dense``: per-lane ``[rows, H, maxT, Dh]`` self-KV and ``[rows, H,
    seq_len, Dh]`` cross-KV buffers, reserved whole for every admitted
    request.

    ``paged``: the self-KV of every layer lives in one shared pool of
    ``n_blocks`` blocks of ``block_size`` positions (``[n_blocks,
    block_size, H, Dh]``), addressed through per-lane int32 block-table
    rows that the host allocates (``HostBlockPool``); the cross-KV lives
    in a pool of ``n_prompt_entries`` whole-prompt entries (+1 dustbin),
    shared and refcounted across lanes with identical prompts
    (``PromptPrefixCache``), so a repeated prompt is encoded once.
    ``chunk_tokens`` > 0 (paged only) adds the ``("chunked", p)`` phase
    programs, which stream a cold prompt's encoder into its entry this
    many prompt tokens a dispatch (chunked prefill).
    """

    layout: str = "dense"
    block_size: int = 8
    n_blocks: int = 0
    n_prompt_entries: int = 0
    chunk_tokens: int = 0

    def validate(self, max_out_len: int):
        if self.layout not in ("dense", "paged"):
            raise ValueError(f"unknown KV layout {self.layout!r}")
        if self.layout == "paged":
            if self.block_size < 1 or self.n_blocks < 1 \
                    or self.n_prompt_entries < 1:
                raise ValueError(
                    f"paged layout needs block_size/n_blocks/"
                    f"n_prompt_entries >= 1, got {self}")
            if max_out_len % self.block_size != 0:
                raise ValueError(
                    f"block_size={self.block_size} must divide "
                    f"max_out_len={max_out_len} (the pages of a lane "
                    f"cover exactly the dense [maxT] positions)")
        if self.chunk_tokens < 0:
            raise ValueError(
                f"chunk_tokens must be >= 0, got {self.chunk_tokens}")
        if self.chunk_tokens and self.layout != "paged":
            raise ValueError(
                "chunked prefill needs the paged layout (chunks land "
                "in the shared prompt-entry pool)")
        if self.chunk_tokens == 1:
            raise ValueError(
                "chunk_tokens == 1 is rejected (the JAX package's "
                "chunked==monolithic parity needs C >= 2)")

    @property
    def chunked(self) -> bool:
        return self.layout == "paged" and self.chunk_tokens > 0

    def n_chunks(self, seq_len: int) -> int:
        """Dispatches one phase takes to stream a seq_len prompt at
        chunk_tokens a dispatch (the last chunk may be ragged)."""
        c = self.chunk_tokens
        return (seq_len + c - 1) // c if c else 0

    def pages(self, max_out_len: int) -> int:
        return max_out_len // self.block_size

    def token(self) -> tuple:
        """Content identity of the layout: two servers differing only
        in KV layout are not the same model."""
        if self.layout == "dense":
            return ("dense",)
        tok = ("paged", self.block_size, self.n_blocks,
               self.n_prompt_entries)
        if self.chunk_tokens:
            tok = tok + ("chunk", self.chunk_tokens)
        return tok

    @staticmethod
    def suggest_chunk_tokens(bundle, tick_budget_ms: float,
                             prefill_ms: float = 150.0) -> int:
        """The largest power-of-two chunk size whose per-dispatch
        prefill slice fits ``tick_budget_ms``
        (``decode_engine.py:244`` in the JAX package). One chunk
        dispatch runs one of the ``2L+2`` phases over C prompt tokens,
        and a monolithic prefill runs all of them over seq_len tokens in
        ``prefill_ms`` (pass a measurement of the shape at hand), so a
        chunk costs about ``prefill_ms * C / (seq_len * (2L+2))``. L is
        read off the bundle's state specs (one cross_k pool a layer);
        the floor is C = 2, since ``validate`` rejects C = 1. Worked
        example: seq_len 2048, L = 1 (4 phases) and a 5.0 ms budget give
        C = 256 (4.69 ms; 512 would take 9.38)."""
        if tick_budget_ms <= 0:
            raise ValueError(
                f"tick_budget_ms must be > 0, got {tick_budget_ms}")
        seq_len = int(bundle.seq_len)
        n_layers = sum(1 for name in bundle._state_specs
                       if "cross_k" in name)
        n_phases = 2 * max(n_layers, 1) + 2

        def tick(c):
            return prefill_ms * c / (seq_len * n_phases)

        c = 2
        while c * 2 <= seq_len and tick(c * 2) <= tick_budget_ms:
            c *= 2
        return c


@dataclass(frozen=True)
class SamplingConfig:
    """Sampling policy of a decode bundle's emission lanes
    (``decode_engine.py:518`` in the JAX package): temperature, top-k and
    top-p filtering, then a draw keyed on the request's seed and the
    position (ops/spec_ops.py). temperature 0 is greedy argmax;
    ``base_seed`` is the bundle's noise root, into which the per-request
    seeds fold, so two bundles with different base seeds sample
    independently."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    base_seed: int = 0

    def validate(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_p <= 0 or self.top_p > 1.0:
            raise ValueError(f"top_p must be in (0, 1], got "
                             f"{self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def token(self) -> tuple:
        return ("sample", float(self.temperature), int(self.top_k),
                float(self.top_p), int(self.base_seed))


@dataclass(frozen=True)
class DraftConfig:
    """The draft of a speculative (draft-and-verify) decode bundle
    (``decode_engine.py:552`` in the JAX package; Leviathan et al.). The
    draft is a smaller encoder-decoder Transformer that lives with the
    target in one scope, every parameter named under ``prefix`` (the
    builder refuses a prefix whose parameters collide with the
    target's). ``k`` proposals a lane a step; k = 0 is the plain
    one-token step.

    * ``kind="ngram"`` replaces the draft model with the model-free
      prompt-lookup proposer: each tick proposes the continuation of the
      rightmost ``ngram``-token suffix match over the prompt and the
      history, as one-hot distributions through the same verify. No
      draft parameters, KV or model steps.
    * ``k_options`` is the adaptive ladder: for every other rung the
      bundle builds its serves again keyed ``("k", kv, base_key)`` over
      the same slot state, so the host controller
      (inference/spec_controller.py) switches rungs by choosing a
      program. ``k`` must be a rung of a non-empty ladder.
    * ``sharded`` opts the draft into a tensor-parallel plan; without
      ``sharding=`` it changes nothing but the token.
    """

    d_model: int = 32
    n_heads: int = 2
    n_layers: int = 1
    d_inner: int = 64
    k: int = 3
    prefix: str = "draft_"
    kind: str = "model"       # "model" | "ngram"
    ngram: int = 2            # suffix-match length for kind="ngram"
    k_options: tuple = ()     # adaptive ladder; () = fixed-k bundle
    sharded: bool = False     # shard draft params and KV under tp

    def validate(self, max_out_len: int):
        if self.k < 0:
            raise ValueError(f"draft k must be >= 0, got {self.k}")
        if self.k + 1 > max_out_len:
            raise ValueError(
                f"draft k={self.k} proposes past the decode buffer "
                f"(max_out_len={max_out_len})")
        if self.kind not in ("model", "ngram"):
            raise ValueError(
                f"draft kind must be 'model' or 'ngram', got "
                f"{self.kind!r}")
        if self.kind == "ngram":
            if self.ngram < 1:
                raise ValueError(
                    f"ngram suffix length must be >= 1, got {self.ngram}")
            if self.sharded:
                raise ValueError(
                    "DraftConfig(kind='ngram') has no draft params to "
                    "shard: sharded=True is meaningless")
        elif self.d_model % self.n_heads:
            raise ValueError(
                f"draft d_model={self.d_model} not divisible by "
                f"n_heads={self.n_heads}")
        if self.k_options:
            opts = tuple(int(v) for v in self.k_options)
            if list(opts) != sorted(set(opts)):
                raise ValueError(
                    f"k_options must be sorted unique ints, got "
                    f"{self.k_options!r}")
            for kv in opts:
                if kv < 0 or kv + 1 > max_out_len:
                    raise ValueError(
                        f"k_options entry {kv} out of range for "
                        f"max_out_len={max_out_len}")
            if self.k not in opts:
                raise ValueError(
                    f"default k={self.k} must be a rung of "
                    f"k_options={self.k_options!r} (the serve keys the "
                    f"controller starts from)")
            if self.k == 0:
                raise ValueError(
                    "adaptive bundles need a speculative default (k > 0): "
                    "the k=0 rung is the degradation target, and every "
                    "draft state spec keys off the default")

    def token(self) -> tuple:
        return ("spec", int(self.k), int(self.d_model),
                int(self.n_heads), int(self.n_layers),
                int(self.d_inner), self.prefix, self.kind,
                int(self.ngram),
                tuple(int(v) for v in self.k_options),
                int(self.sharded))


class DecodeStepBundle:
    """Program set for slot-pool continuous batching
    (``decode_engine.py:972`` in the JAX package).

    All per-slot decode state is persistable scope state shared by the
    programs: KV caches, token buffers, per-lane step counters, the
    finished and active masks, and (paged) the host-owned block table,
    prompt refs and teacher-forcing horizon. The pool holds ``n_slots``
    schedulable lanes plus one dustbin row (index ``n_slots``) that
    absorbs the padded rows of a bucketed admission; it decodes garbage
    harmlessly, its paged pool writes are gated off, and it is never
    scheduled.

    * ``prefills[A]``: one admission program per bucket size A (feeds
      ``src_ids`` [A, seq_len], ``slots`` [A] and, paged,
      ``prompt_slots`` [A]); paged bundles also carry ``hit_prefills[A]``,
      encoder-free admissions of prompts whose entry is cached.
    * ``step``: no feeds; advances every lane one token.
    * ``serves[key]``: the fused scheduler-cycle programs, an admission
      body (absent at key 0) followed by a While that runs the step
      body until ``n_steps`` ticks ran or the live-lane count drops to
      ``min_active`` (both fed as [1] int64). Keys are admission buckets
      (ints) for dense bundles and ``("hit"|"miss"|"radix", A)`` plus 0
      for paged ones; ``serve_feed_spec(key)`` names each feed
      signature. A radix admission scatters a lane's token history
      into ``tok_buf`` and resumes it past the shared blocks its table
      maps, teacher-forced up to ``prefill_until``.
    * ``cow`` (paged): copies shared self-KV blocks into fresh exclusive
      ones in every layer's pool (feeds ``cow_feed_spec()``); ``probe``
      (paged): one step tick that also publishes every lane's softmax
      row to ``state["probe_probs"]``. ``PagedBeamDecoder`` runs both.
    * ``("chunked", p)`` serves (``CacheConfig(chunk_tokens=C)``): phase
      p of a cold prompt's encoder over C prompt positions, written into
      the prompt entry's staging rows, followed by the same decode While
      as key 0 (``chunk_phase_keys`` lists them in phase order).
    * ``sampling`` (``SamplingConfig``): the step draws each lane's token
      from the filtered distribution, keyed on the lane's seed (fed as
      ``seeds`` at every admission: ``needs_seeds``) and position.
    * ``draft`` (``DraftConfig``): the step proposes k tokens a lane and
      verifies them in one k+1-query target step; every admission feeds
      ``seeds`` and ``src_ids`` (hits too: the draft's encoder runs per
      lane). With ``k_options`` the serves also hold ``("k", kv,
      base_key)`` variants, one set a rung, over the same slot state.

    ``state`` maps logical names to scope var names;
    ``init_slot_state(scope, device)`` seeds the pool. ``startup`` holds
    the parameter initializers only: serving runs against a scope that
    already holds the weights.
    """

    def __init__(self, prefills, step, serves, startup, state, n_slots,
                 seq_len, max_out_len, start_id, end_id, cache=None,
                 hit_prefills=None, sampling=None, draft=None, cow=None,
                 probe=None):
        self.prefills = dict(prefills)
        self.prefill = self.prefills[min(self.prefills)]
        self.hit_prefills = dict(hit_prefills or {})
        self.step = step
        self.serves = dict(serves)
        self.startup = startup
        self.state = dict(state)
        self.n_slots = n_slots
        self.dustbin = n_slots
        self.seq_len = seq_len
        self.max_out_len = max_out_len
        self.start_id = start_id
        self.end_id = end_id
        self.cache = cache or CacheConfig()
        self.sampling = sampling  # SamplingConfig, or None (greedy)
        self.draft = draft        # DraftConfig, or None
        self.cow = cow        # COW block-copy Program (paged)
        self.probe = probe    # probe-step Program (paged)
        self._state_specs: Dict[str, tuple] = {}

    def programs(self):
        """Every program of the bundle, in a stable order (prefills, hit
        prefills, step, cow, probe, serves)."""
        out = [p for _a, p in sorted(self.prefills.items())]
        out += [p for _a, p in sorted(self.hit_prefills.items())]
        out.append(self.step)
        out += [p for p in (self.cow, self.probe) if p is not None]
        out += [p for _k, p in sorted(self.serves.items(),
                                      key=lambda kv: str(kv[0]))]
        return out

    @property
    def chunk_phase_keys(self):
        """The ``("chunked", p)`` serve keys in phase order (empty on an
        unchunked bundle). A prompt walks them phase-major: phase p at
        every chunk cursor before phase p+1, since an attention phase
        reads its layer's K/V at every prompt position. A prompt takes
        ``n_chunks * len(chunk_phase_keys)`` dispatches."""
        return sorted((k for k in self.serves
                       if isinstance(k, tuple) and k[0] == "chunked"),
                      key=lambda kv: kv[1])

    @property
    def spec_k(self) -> int:
        """Draft proposals a lane a step (0: plain decode)."""
        return self.draft.k if self.draft is not None else 0

    @property
    def spec_k_options(self) -> tuple:
        """The pre-built adaptive-k ladder (empty on fixed-k and plain
        bundles)."""
        if self.draft is None:
            return ()
        return tuple(int(v) for v in self.draft.k_options)

    @property
    def tokens_per_tick(self) -> int:
        """The most tokens one device tick emits a lane (k accepted
        proposals and the correction or bonus); the paged scheduler sizes
        block coverage by it. A ladder sizes by its top rung."""
        return max((self.spec_k,) + self.spec_k_options) + 1

    @property
    def needs_seeds(self) -> bool:
        """Whether admissions feed per-request noise seeds (sampled
        emission, or any draft: the acceptance draws are keyed on
        them)."""
        return self.sampling is not None or self.draft is not None

    def cache_token(self) -> tuple:
        """Content identity for the servers: the KV layout, plus the
        draft and the sampling policy (a speculative, a sampled and a
        plain bundle over the same weights serve different token
        streams)."""
        tok = self.cache.token()
        if self.draft is not None:
            tok = tok + self.draft.token()
        if self.sampling is not None:
            tok = tok + self.sampling.token()
        return tok

    def serve_feed_spec(self, key) -> List[tuple]:
        """Feed signature (name, shape, dtype) of ``serves[key]``."""
        feed = [("n_steps", (1,), "int64"),
                ("min_active", (1,), "int64")]
        if isinstance(key, tuple) and key[0] == "k":
            # a ladder rung: the base key's admission and feeds
            return self.serve_feed_spec(key[2])
        if key == 0:
            return feed
        tier, A = key if isinstance(key, tuple) else ("miss", key)
        seeds = [("seeds", (A,), "int64")] if self.needs_seeds else []
        if tier == "radix":
            return [("hist_toks", (A, self.max_out_len), "int64"),
                    ("resume_steps", (A,), "int64"),
                    ("prefill_until", (A,), "int64"),
                    ("slots", (A,), "int64")] + seeds + feed
        if tier == "chunked":
            # A is the phase here: 0 embeds, 1 + 2l and 2 + 2l are layer
            # l's K/V and attention phases, 2L + 1 installs the cross K/V
            pre = [("chunk_entry", (1,), "int64"),
                   ("chunk_pos", (1,), "int64")]
            if A == 0:
                pre.append(("chunk_toks", (1, self.cache.chunk_tokens),
                            "int64"))
            return pre + feed
        pre = []
        if tier == "miss" or self.spec_k > 0:
            # a speculative hit feeds src_ids too: the draft's encoder
            # runs per lane, only the target's is skipped
            pre.append(("src_ids", (A, self.seq_len), "int64"))
        pre.append(("slots", (A,), "int64"))
        if tier == "miss" and self.cache.layout == "paged":
            pre.append(("prompt_slots", (A,), "int64"))
        return pre + seeds + feed

    def cow_feed_spec(self) -> List[tuple]:
        """Feed signature of the COW program: per row the shared source
        block, the fresh exclusive destination block and a 0/1 gate.
        Padded rows feed gate 0 and destination -1 (the trash row)."""
        rows = self.n_slots + 1
        return [("cow_src", (rows,), "int64"),
                ("cow_dst", (rows,), "int64"),
                ("cow_gate", (rows,), "float32")]

    def kv_state_bytes(self) -> int:
        """Persistable KV bytes of the bundle (self and cross KV with the
        table and prompt-ref state; token and flag buffers excluded)."""
        total = 0
        for name, (shape, dt) in self._state_specs.items():
            short = name.split("/")[-1]
            if short.startswith(("self_", "cross_", "block_tab",
                                 "prompt_ref", "draft_self_",
                                 "draft_cross_")):
                total += int(np.prod(shape)) * np.dtype(dt).itemsize
        return total

    def init_slot_state(self, scope, device="cuda"):
        """Seed the pool state in `scope` on `device`: the card unless
        the caller names another, as ``Executor()`` runs on
        ``CUDAPlace(0)``. Idle slots: finished=1, active=0, so they step
        harmlessly until admitted; paged prompt refs point every lane at
        the dustbin entry."""
        import torch

        for name, (shape, dt) in self._state_specs.items():
            if name == self.state["finished"]:
                val = np.ones(shape, dt)
            elif name == self.state.get("prompt_ref"):
                val = np.full(shape, self.cache.n_prompt_entries, dt)
            else:
                val = np.zeros(shape, dt)
            scope._set(name, torch.from_numpy(val).to(device))


def _slot_state_specs(prefix, rows, maxT, seq_len, n_heads, head_dim,
                      n_layers, cache, sampling=None, vocab=None,
                      draft=None):
    """name -> (shape, dtype) of every slot-state persistable
    (``decode_engine.py:1223`` in the JAX package)."""
    specs = {
        f"{prefix}tok_buf": ((rows, maxT), "int64"),
        f"{prefix}step": ((rows,), "int64"),
        f"{prefix}finished": ((rows,), "int64"),
        f"{prefix}active": ((rows,), "int64"),
    }
    if sampling is not None or draft is not None:
        # each lane's noise seed, written at admission from the fed
        # per-request seeds
        specs[f"{prefix}seed"] = ((rows,), "int64")
    if draft is not None and draft.k > 0:
        if draft.kind == "model":
            dh = draft.d_model // draft.n_heads
            # the draft's self-KV stays dense per lane in both target
            # layouts (the draft is small), and so does its cross-KV
            # (its encoder runs at every admission, hits included)
            for li in range(draft.n_layers):
                for kind, t in (("self", maxT), ("cross", seq_len)):
                    for kv in ("k", "v"):
                        specs[f"{prefix}draft_{kind}_{kv}{li}"] = (
                            (rows, draft.n_heads, t, dh), "float32")
        else:
            # the n-gram proposer's per-lane prompt copy (tok_buf holds
            # the history)
            specs[f"{prefix}prompt_toks"] = ((rows, seq_len), "int64")
        # speculative accounting ([1] int64 counters the servers delta a
        # dispatch), and per lane the accepted proposals and verify
        # ticks (the adaptive controller's signal)
        for c in ("spec_proposed", "spec_accepted", "spec_emitted",
                  "spec_draft_steps", "spec_target_steps"):
            specs[f"{prefix}{c}"] = ((1,), "int64")
        specs[f"{prefix}spec_lane_accepted"] = ((rows,), "int64")
        specs[f"{prefix}spec_lane_ticks"] = ((rows,), "int64")
        if draft.k_options:
            specs.update(devtel.spec_k_counter_specs(prefix,
                                                     draft.k_options))
    specs.update(devtel.counter_specs(prefix, cache.layout == "paged",
                                      chunked=cache.chunked))
    if cache.layout == "dense":
        for li in range(n_layers):
            specs[f"{prefix}self_k{li}"] = (
                (rows, n_heads, maxT, head_dim), "float32")
            specs[f"{prefix}self_v{li}"] = (
                (rows, n_heads, maxT, head_dim), "float32")
            specs[f"{prefix}cross_k{li}"] = (
                (rows, n_heads, seq_len, head_dim), "float32")
            specs[f"{prefix}cross_v{li}"] = (
                (rows, n_heads, seq_len, head_dim), "float32")
        return specs
    NP = cache.pages(maxT)
    E = cache.n_prompt_entries
    specs[f"{prefix}block_tab"] = ((rows, NP), "int32")
    specs[f"{prefix}prompt_ref"] = ((rows,), "int32")
    # teacher-forcing horizon per lane: while step+1 < prefill_until a
    # lane replays its token-buffer history (KV written, the emitted
    # token dropped, EOS never latched). 0, the default, makes every
    # tick a real decode tick.
    specs[f"{prefix}prefill_until"] = ((rows,), "int64")
    if cache.chunked:
        # chunked-prefill staging, one row per prompt entry (+1 dustbin),
        # as the cross pools: the encoder is bidirectional (layer l+1
        # reads layer l at every position), so a resumable prefill keeps
        # whole-prompt activations. a and b hold a layer's input and
        # output in turn; kv holds the layer's self-attention K and V
        # (every position's, before any query chunk attends)
        d_model = n_heads * head_dim
        specs[f"{prefix}chunk_stage_a{POOL_MARK}"] = (
            (E + 1, seq_len, d_model), "float32")
        specs[f"{prefix}chunk_stage_b{POOL_MARK}"] = (
            (E + 1, seq_len, d_model), "float32")
        specs[f"{prefix}chunk_stage_kv{POOL_MARK}"] = (
            (E + 1, seq_len, 2 * d_model), "float32")
    if vocab is not None and (draft is None or draft.k == 0):
        # the probe step's output: one softmax row a lane, which the
        # beam decoder branches on
        specs[f"{prefix}probe_probs"] = ((rows, vocab), "float32")
    for li in range(n_layers):
        specs[f"{prefix}self_k{li}{POOL_MARK}"] = (
            (cache.n_blocks, cache.block_size, n_heads, head_dim),
            "float32")
        specs[f"{prefix}self_v{li}{POOL_MARK}"] = (
            (cache.n_blocks, cache.block_size, n_heads, head_dim),
            "float32")
        # +1: the dustbin entry padded admission rows write into
        specs[f"{prefix}cross_k{li}{POOL_MARK}"] = (
            (E + 1, n_heads, seq_len, head_dim), "float32")
        specs[f"{prefix}cross_v{li}{POOL_MARK}"] = (
            (E + 1, n_heads, seq_len, head_dim), "float32")
    return specs


def _declare_slot_state(block, specs):
    """Declare the persistable slot-state vars in a program's global
    block: every program binds the same scope values by name."""
    return {name: block.create_var(name=name, shape=shape, dtype=dt,
                                   persistable=True, stop_gradient=True)
            for name, (shape, dt) in specs.items()}


def _param_probe(prefix, seq_len, max_out_len, d_model, n_heads,
                 n_layers, d_inner, vocab):
    """A throwaway program that creates every parameter the
    ``prefix``-named encoder-decoder decode stack owns, through the code
    that creates them in the bundle (``decode_engine.py:1661`` in the
    JAX package), so the name set cannot drift from the builders."""
    from . import transformer as T

    head_dim = d_model // n_heads
    maxT = max_out_len
    main = Program()
    with program_guard(main, Program()):
        src = layers.data("src_ids", shape=[1, seq_len], dtype="int64",
                          append_batch_size=False)
        enc = T._embed(src, vocab, d_model, max(seq_len, maxT), 0.0,
                       True, f"{prefix}src_word_emb")
        for li in range(n_layers):
            enc = T.encoder_layer(enc, d_model, n_heads, d_inner, 0.0,
                                  is_test=True, name=f"{prefix}enc{li}")
        cross = []
        for li in range(n_layers):
            kvp = layers.fc(enc, 2 * d_model, num_flatten_dims=2,
                            bias_attr=False,
                            param_attr=T._attn_proj_attr(
                                f"{prefix}dec{li}_cross", "kv", d_model))
            k, v = layers.split(kvp, 2, dim=2)
            cross.append((heads_of(k, seq_len, n_heads, head_dim),
                          heads_of(v, seq_len, n_heads, head_dim)))
        ids = layers.assign(np.zeros((1, 1), "int64"))
        x = layers.unsqueeze(
            layers.embedding(ids, size=[vocab, d_model],
                             param_attr=ParamAttr(
                                 name=f"{prefix}tgt_word_emb")), [1])
        wm = layers.assign(np.zeros((1, 1, maxT, 1), "float32"))
        km = layers.assign(np.ones((1, 1, maxT, 1), "float32"))
        caches = [_DenseLaneCache(
            layers.assign(np.zeros((1, n_heads, maxT, head_dim),
                                   "float32")),
            layers.assign(np.zeros((1, n_heads, maxT, head_dim),
                                   "float32")), wm, km)
            for _ in range(n_layers)]
        bias = layers.assign(np.zeros((maxT,), "float32"))
        x = cached_decoder_step(x, caches, cross, bias, d_model, n_heads,
                                d_inner, prefix=prefix)
        layers.fc(layers.reshape(x, [0, d_model]), vocab,
                  bias_attr=False, param_attr=f"{prefix}logits.w")
    return main


def _pair_lint_draft_target(draft, *, seq_len, max_out_len, d_model,
                            n_heads, n_layers, d_inner, vocab):
    """The draft lives with the target in one scope, so any persistable
    name the two share would alias or clobber a weight (the JAX
    package's PTA100 check, ``check_cross_model_collision``). Raises
    ValueError naming every shared persistable; a distinct
    ``draft.prefix`` keeps it silent."""
    def persistables(prog):
        return {v.name: v for v in prog.list_vars()
                if getattr(v, "persistable", False)}

    target = persistables(_param_probe(
        "", seq_len, max_out_len, d_model, n_heads, n_layers, d_inner,
        vocab))
    probe = persistables(_param_probe(
        draft.prefix, seq_len, max_out_len, draft.d_model, draft.n_heads,
        draft.n_layers, draft.d_inner, vocab))
    shared = sorted(set(target) & set(probe))
    if shared:
        lines = [f"  PTA100 error: both models declare persistable "
                 f"{name!r} (target shape {tuple(target[name].shape)}, "
                 f"draft shape {tuple(probe[name].shape)})"
                 for name in shared]
        raise ValueError(
            f"speculative draft (prefix {draft.prefix!r}) collides with "
            f"the target model's persistables: co-residence in one scope "
            f"would alias or clobber weights (PTA100):\n"
            + "\n".join(lines))


def build_decode_step_program(seq_len=16, max_out_len=16, d_model=64,
                              n_heads=4, n_layers=2, d_inner=128,
                              vocab=1000, start_id=0, end_id=1,
                              n_slots=8, admit_buckets=None,
                              state_prefix="@cb/", cache=None,
                              sampling=None, draft=None, sharding=None):
    """Build the slot-pool continuous-batching bundle
    (``decode_engine.py:1747`` in the JAX package; see
    DecodeStepBundle). The step's per-layer math is the whole-loop
    program's (``cached_decoder_step``) with the scalar loop counter
    replaced by a per-lane counter vector, so a lane decodes token for
    token what ``build_incremental_decode_program`` decodes.

    ``admit_buckets`` bounds the admission specializations (default:
    1, 2, 4, ... capped at n_slots); padded rows of a bucket land on
    the dustbin lane. ``cache`` (CacheConfig) selects the KV layout and,
    with ``chunk_tokens > 0``, adds the chunked-prefill phase programs.
    ``sampling`` (SamplingConfig) replaces the greedy argmax with
    temperature/top-k/top-p lanes keyed on per-request seeds, which every
    admission then feeds. ``draft`` (DraftConfig) makes the step
    speculative: k unrolled cached draft steps (or the n-gram proposer)
    propose tokens a lane, one k+1-query target step verifies them, and
    each lane advances by its accepted prefix and the correction or
    bonus token. Greedy speculation is token-exact against the whole-loop
    decode; sampled speculation keeps the target's filtered distribution
    by the rejection rule; k = 0 is the plain step. The draft's
    parameters are refused at build when their names collide with the
    target's. ``sharding`` (tensor-parallel bundles, serving step 10 of
    the port) raises NotImplementedError.

    Returns a DecodeStepBundle.
    """
    from . import transformer as T

    if sharding is not None:
        raise NotImplementedError(
            "build_decode_step_program(sharding=...): tensor-parallel "
            "bundles are not ported yet (serving step 10 of the port: "
            "ShardingConfig); build an unsharded bundle")
    cache = cache or CacheConfig()
    cache.validate(max_out_len)
    if sampling is not None:
        sampling.validate()
    if draft is not None:
        draft.validate(max_out_len)
        if draft.kind == "model":
            _pair_lint_draft_target(
                draft, seq_len=seq_len, max_out_len=max_out_len,
                d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                d_inner=d_inner, vocab=vocab)
    spec = draft is not None and draft.k > 0
    ngram = spec and draft.kind == "ngram"
    greedy = sampling is None or sampling.greedy
    samp = sampling or SamplingConfig(temperature=0.0)
    needs_seeds = sampling is not None or draft is not None
    paged = cache.layout == "paged"
    head_dim = d_model // n_heads
    maxT = max_out_len
    rows = n_slots + 1  # + the dustbin lane for padded admissions
    if admit_buckets is None:
        admit_buckets, b = [], 1
        while b < n_slots:
            admit_buckets.append(b)
            b *= 2
        admit_buckets.append(n_slots)
    admit_buckets = sorted(set(int(a) for a in admit_buckets))
    if admit_buckets[0] < 1 or admit_buckets[-1] > n_slots:
        raise ValueError(
            f"admit_buckets {admit_buckets} must lie in "
            f"[1, n_slots={n_slots}]")
    specs = _slot_state_specs(state_prefix, rows, maxT, seq_len,
                              n_heads, head_dim, n_layers, cache,
                              sampling=sampling,
                              vocab=vocab if paged else None,
                              draft=draft)
    if paged:
        NP, BS, NB = cache.pages(maxT), cache.block_size, cache.n_blocks
        E = cache.n_prompt_entries
        # the paged step's self-attention takes kernel #9 when its
        # shapes fit, decided here by shape alone; else the JAX
        # package's gather-view composition
        routed = KPA.usable(
            types.SimpleNamespace(shape=(rows, n_heads, head_dim)),
            types.SimpleNamespace(shape=(NB, BS, n_heads, head_dim)),
            types.SimpleNamespace(shape=(rows, NP)))

    def _tel_add(sv, logical, delta):
        """var = var + delta on a device counter (skipped for counters
        this layout does not carry)."""
        var = sv.get(f"{state_prefix}{logical}{devtel.TEL_MARK}")
        if var is None:
            return
        layers.assign(layers.elementwise_add(var, delta), output=var)

    def _lane_onehots(slots, A):
        lane_range = layers.cast(layers.range(0, rows, 1), "int64")
        # [A, rows] one-hot per admitted prompt; padded rows all point
        # at the dustbin, whose multiplicity min() clamps
        oh = layers.cast(
            layers.equal(lane_range, layers.reshape(slots, [A, 1])),
            "float32")
        any_f = layers.elementwise_min(
            layers.reduce_sum(oh, dim=0),
            layers.fill_constant([rows], "float32", 1.0))
        any_i = layers.cast(any_f, "int64")
        keep_f = layers.elementwise_sub(
            layers.fill_constant([rows], "float32", 1.0), any_f)
        keep_i = layers.elementwise_sub(
            layers.fill_constant([rows], "int64", 1.0), any_i)
        return oh, any_f, any_i, keep_f, keep_i

    def _reset_lane_state(sv, any_i, keep_i, oh=None, seeds=None,
                          tier="miss"):
        # token buffer rows: start_id at position 0, zeros elsewhere
        positions = layers.cast(layers.range(0, maxT, 1), "int64")
        start_col = layers.cast(
            layers.equal(positions,
                         layers.fill_constant([1], "int64", 0.0)),
            "int64")
        row_init = layers.cast(
            layers.scale(start_col, scale=float(start_id)), "int64")
        any_col = layers.reshape(any_i, [rows, 1])
        keep_col = layers.reshape(keep_i, [rows, 1])
        tok_buf = sv[f"{state_prefix}tok_buf"]
        layers.assign(layers.elementwise_add(
            layers.elementwise_mul(tok_buf, keep_col),
            layers.elementwise_mul(any_col, row_init)), output=tok_buf)
        stepv = sv[f"{state_prefix}step"]
        layers.assign(layers.elementwise_mul(stepv, keep_i),
                      output=stepv)
        fin = sv[f"{state_prefix}finished"]
        layers.assign(layers.elementwise_mul(fin, keep_i), output=fin)
        pfu = sv.get(f"{state_prefix}prefill_until")
        if pfu is not None:
            layers.assign(layers.elementwise_mul(pfu, keep_i),
                          output=pfu)
        if seeds is not None:
            # per-request noise seeds scatter to their lanes in integer
            # arithmetic (a float32 one-hot product would round 32-bit
            # seeds past 2^24); dustbin duplicates sum to garbage there
            oh_i = layers.cast(oh, "int64")  # [A, rows]
            scat = layers.reduce_sum(
                layers.elementwise_mul(
                    oh_i, layers.reshape(seeds, [-1, 1])), dim=0)
            seedv = sv[f"{state_prefix}seed"]
            layers.assign(layers.elementwise_add(
                layers.elementwise_mul(seedv, keep_i), scat),
                output=seedv)
        act = sv[f"{state_prefix}active"]
        # the dustbin lane never activates: it must not hold the serve
        # While open nor count against min_active
        valid = layers.assign((np.arange(rows) < n_slots).astype("int64"))
        layers.assign(layers.elementwise_add(
            layers.elementwise_mul(act, keep_i),
            layers.elementwise_mul(any_i, valid)), output=act)
        _tel_add(sv, f"tel_admit_{tier}",
                 layers.reduce_sum(layers.elementwise_mul(any_i, valid),
                                   keep_dim=True))

    def _seeds_data(A):
        if not needs_seeds:
            return None
        return layers.data("seeds", shape=[A], dtype="int64",
                           append_batch_size=False)

    def _draft_admit(sv, src, A, oh, keep_f):
        """Speculative admission tail: the draft's encoder over the
        admitted prompts, its per-lane cross-KV installed and its self-KV
        zeroed. Runs on every admission flavor, paged hits included: the
        draft's cross-KV is per-lane state."""
        dd = draft.d_model
        dh = dd // draft.n_heads
        denc = T._embed(src, vocab, dd, max(seq_len, maxT), 0.0, True,
                        f"{draft.prefix}src_word_emb")
        for li in range(draft.n_layers):
            denc = T.encoder_layer(denc, dd, draft.n_heads, draft.d_inner,
                                   0.0, is_test=True,
                                   name=f"{draft.prefix}enc{li}")
        keep4 = layers.reshape(keep_f, [rows, 1, 1, 1])
        ohT = layers.transpose(oh, perm=[1, 0])  # [rows, A]
        flat = draft.n_heads * seq_len * dh
        for li in range(draft.n_layers):
            kvp = layers.fc(denc, 2 * dd, num_flatten_dims=2,
                            bias_attr=False,
                            param_attr=T._attn_proj_attr(
                                f"{draft.prefix}dec{li}_cross", "kv", dd))
            k, v = layers.split(kvp, 2, dim=2)
            for var, new in (
                    (sv[f"{state_prefix}draft_cross_k{li}"],
                     heads_of(k, seq_len, draft.n_heads, dh)),
                    (sv[f"{state_prefix}draft_cross_v{li}"],
                     heads_of(v, seq_len, draft.n_heads, dh))):
                scat = layers.reshape(
                    layers.matmul(ohT, layers.reshape(new, [A, flat])),
                    [rows, draft.n_heads, seq_len, dh])
                layers.assign(layers.elementwise_add(
                    layers.elementwise_mul(var, keep4), scat), output=var)
            for var in (sv[f"{state_prefix}draft_self_k{li}"],
                        sv[f"{state_prefix}draft_self_v{li}"]):
                layers.assign(layers.elementwise_mul(var, keep4),
                              output=var)

    def _ngram_admit(sv, src, A, oh, keep_f):
        """Model-free draft admission: the prompts scatter into the
        admitted lanes' ``prompt_toks`` copies, the text the suffix
        matcher scans (token ids < vocab << 2^24, so the float32 one-hot
        matmul scatter is exact)."""
        ohT = layers.transpose(oh, perm=[1, 0])            # [rows, A]
        scat = layers.cast(
            layers.matmul(ohT, layers.cast(src, "float32")), "int64")
        keep_col = layers.reshape(layers.cast(keep_f, "int64"), [rows, 1])
        var = sv[f"{state_prefix}prompt_toks"]
        layers.assign(layers.elementwise_add(
            layers.elementwise_mul(var, keep_col), scat), output=var)

    def _spec_admit(sv, src, A, oh, keep_f):
        if ngram:
            _ngram_admit(sv, src, A, oh, keep_f)
        else:
            _draft_admit(sv, src, A, oh, keep_f)

    def _encode_prompts(A):
        src = layers.data("src_ids", shape=[A, seq_len], dtype="int64",
                          append_batch_size=False)
        enc = T._embed(src, vocab, d_model, max(seq_len, maxT), 0.0,
                       True, "src_word_emb")
        for li in range(n_layers):
            enc = T.encoder_layer(enc, d_model, n_heads, d_inner, 0.0,
                                  is_test=True, name=f"enc{li}")
        return src, enc

    def _cross_proj(enc, li):
        kvp = layers.fc(enc, 2 * d_model, num_flatten_dims=2,
                        bias_attr=False,
                        param_attr=T._attn_proj_attr(
                            f"dec{li}_cross", "kv", d_model))
        k, v = layers.split(kvp, 2, dim=2)
        return (heads_of(k, seq_len, n_heads, head_dim),
                heads_of(v, seq_len, n_heads, head_dim))

    def _admit_body_dense(sv, A):
        src, enc = _encode_prompts(A)
        slots = layers.data("slots", shape=[A], dtype="int64",
                            append_batch_size=False)
        seeds = _seeds_data(A)
        oh, _, any_i, keep_f, keep_i = _lane_onehots(slots, A)
        keep4 = layers.reshape(keep_f, [rows, 1, 1, 1])
        ohT = layers.transpose(oh, perm=[1, 0])  # [rows, A]
        flat = n_heads * seq_len * head_dim
        for li in range(n_layers):
            kh, vh = _cross_proj(enc, li)
            for var, new in ((sv[f"{state_prefix}cross_k{li}"], kh),
                             (sv[f"{state_prefix}cross_v{li}"], vh)):
                # one-hot matmul scatter: row a of `new` lands on lane
                # slots[a]; other lanes keep their value through keep4
                scat = layers.reshape(
                    layers.matmul(ohT, layers.reshape(new, [A, flat])),
                    [rows, n_heads, seq_len, head_dim])
                layers.assign(layers.elementwise_add(
                    layers.elementwise_mul(var, keep4), scat),
                    output=var)
            for var in (sv[f"{state_prefix}self_k{li}"],
                        sv[f"{state_prefix}self_v{li}"]):
                layers.assign(layers.elementwise_mul(var, keep4),
                              output=var)
        if spec:
            _spec_admit(sv, src, A, oh, keep_f)
        _reset_lane_state(sv, any_i, keep_i, oh=oh, seeds=seeds)

    def _admit_body_paged_miss(sv, A):
        """Cold-prompt admission: encode, write the cross-KV into the
        fed prompt-pool entries (host-distinct; padded rows aim at the
        dustbin entry E), reset the lanes. Fresh lanes need no self-pool
        zeroing: every position <= step is written before it is read."""
        src, enc = _encode_prompts(A)
        slots = layers.data("slots", shape=[A], dtype="int64",
                            append_batch_size=False)
        pslots = layers.data("prompt_slots", shape=[A], dtype="int64",
                             append_batch_size=False)
        seeds = _seeds_data(A)
        for li in range(n_layers):
            kh, vh = _cross_proj(enc, li)
            for var, new in (
                    (sv[f"{state_prefix}cross_k{li}{POOL_MARK}"], kh),
                    (sv[f"{state_prefix}cross_v{li}{POOL_MARK}"], vh)):
                layers.masked_pool_write(var, new, pslots,
                                         leading_dims=1,
                                         exclusive_via="host_indices")
        oh, _, any_i, keep_f, keep_i = _lane_onehots(slots, A)
        if spec:
            _spec_admit(sv, src, A, oh, keep_f)
        _reset_lane_state(sv, any_i, keep_i, oh=oh, seeds=seeds)

    def _admit_body_paged_hit(sv, A):
        """Prefix-hit admission: the prompt's cross-KV entry is already
        pooled (its refcount bumped by the host), so admission is a lane
        reset only: no target encoder, no pool write. A speculative
        bundle feeds src_ids here too and runs the draft's admission."""
        if spec:
            src = layers.data("src_ids", shape=[A, seq_len],
                              dtype="int64", append_batch_size=False)
        slots = layers.data("slots", shape=[A], dtype="int64",
                            append_batch_size=False)
        seeds = _seeds_data(A)
        oh, _, any_i, keep_f, keep_i = _lane_onehots(slots, A)
        if spec:
            _spec_admit(sv, src, A, oh, keep_f)
        _reset_lane_state(sv, any_i, keep_i, oh=oh, seeds=seeds,
                          tier="hit")

    def _admit_body_paged_radix(sv, A):
        """Radix-resume admission (chat sessions, n-best fan-out, a
        retired plain prompt sent again): the prompt's cross-KV entry is
        pooled (a hit) and the host maps the longest shared block prefix
        of the lane's token history read-only into its table, so those
        positions are neither encoded nor replayed. The lane's row takes
        the whole history, its step the first position past the shared
        blocks (every write lands in a fresh exclusive block) and its
        prefill_until the history length: the divergent tail replays
        teacher-forced before real decoding starts."""
        hist = layers.data("hist_toks", shape=[A, maxT], dtype="int64",
                           append_batch_size=False)
        resume = layers.data("resume_steps", shape=[A], dtype="int64",
                             append_batch_size=False)
        until = layers.data("prefill_until", shape=[A], dtype="int64",
                            append_batch_size=False)
        slots = layers.data("slots", shape=[A], dtype="int64",
                            append_batch_size=False)
        seeds = _seeds_data(A)
        oh, _, any_i, _, keep_i = _lane_onehots(slots, A)
        _reset_lane_state(sv, any_i, keep_i, oh=oh, seeds=seeds,
                          tier="radix")
        # overwrite the reset's cold-start row and counters with the
        # history: token ids < vocab << 2^24, so the float32 one-hot
        # product scatters them exactly; the counters take the integer
        # scatter
        ohT = layers.transpose(oh, perm=[1, 0])            # [rows, A]
        hist_scat = layers.cast(
            layers.matmul(ohT, layers.cast(hist, "float32")),
            "int64")                                       # [R,maxT]
        any_col = layers.reshape(any_i, [rows, 1])
        keep_col = layers.reshape(keep_i, [rows, 1])
        tok_buf = sv[f"{state_prefix}tok_buf"]
        layers.assign(layers.elementwise_add(
            layers.elementwise_mul(tok_buf, keep_col),
            layers.elementwise_mul(hist_scat, any_col)), output=tok_buf)
        oh_i = layers.cast(oh, "int64")
        for feed_v, state_name in ((resume, "step"),
                                   (until, "prefill_until")):
            var = sv[f"{state_prefix}{state_name}"]
            scat = layers.reduce_sum(
                layers.elementwise_mul(
                    oh_i, layers.reshape(feed_v, [-1, 1])), dim=0)
            layers.assign(layers.elementwise_add(
                layers.elementwise_mul(var, keep_i), scat), output=var)

    admit_bodies = {"miss": _admit_body_paged_miss if paged
                    else _admit_body_dense}
    if paged:
        admit_bodies["hit"] = _admit_body_paged_hit
        if not spec:
            # the radix tier rides the plain step: a speculative lane
            # advances by variable lengths, which the block-aligned
            # resume does not model
            admit_bodies["radix"] = _admit_body_paged_radix

    prefills, hit_prefills = {}, {}
    startup = None
    for A in admit_buckets:
        prog, st = Program(), Program()
        with program_guard(prog, st):
            admit_bodies["miss"](
                _declare_slot_state(prog.global_block, specs), A)
        prefills[A] = prog
        startup = startup or st
        if paged:
            hprog = Program()
            with program_guard(hprog, Program()):
                admit_bodies["hit"](
                    _declare_slot_state(hprog.global_block, specs), A)
            hit_prefills[A] = hprog

    def _paged_cross_kv(sv):
        """Every lane's cross-KV of each layer, gathered from the prompt
        pools through its prompt_ref: [(ck, cv)] of [R,H,S,Dh]."""
        pref = sv[f"{state_prefix}prompt_ref"]
        cross_kv = []
        for li in range(n_layers):
            pair = []
            for tag in ("k", "v"):
                pool = sv[f"{state_prefix}cross_{tag}{li}{POOL_MARK}"]
                flat = layers.reshape(
                    pool, [E + 1, n_heads * seq_len * head_dim])
                got = layers.gather(flat, pref)             # [R, HSD]
                pair.append(layers.reshape(
                    got, [rows, n_heads, seq_len, head_dim]))
            cross_kv.append(tuple(pair))
        return cross_kv

    def _step_body(sv, probe=False):
        """One token over every lane (the standalone step program, the
        serve programs' While and, with ``probe``, the probe program
        share it)."""
        tok_buf = sv[f"{state_prefix}tok_buf"]
        stepv = sv[f"{state_prefix}step"]
        fin = sv[f"{state_prefix}finished"]
        act = sv[f"{state_prefix}active"]
        # one tick ran; the occupancy integral reads act before this
        # tick's retirements
        _tel_add(sv, "tel_ticks", layers.fill_constant([1], "int64", 1.0))
        _tel_add(sv, "tel_occupancy", layers.reduce_sum(act,
                                                        keep_dim=True))
        positions = layers.cast(layers.range(0, maxT, 1), "int64")
        pos_table = layers.assign(
            T._position_encoding(max(seq_len, maxT), d_model)[:maxT])
        step2 = layers.reshape(stepv, [rows, 1])            # [R,1]
        t_mask = layers.cast(layers.equal(positions, step2),
                             "float32")                     # [R,maxT]
        cur_tok = layers.reduce_sum(
            layers.elementwise_mul(tok_buf, layers.cast(t_mask, "int64")),
            dim=1, keep_dim=True)                           # [R,1]
        x = layers.embedding(cur_tok, size=[vocab, d_model],
                             param_attr=ParamAttr(name="tgt_word_emb"))
        x = layers.unsqueeze(x, [1])                        # [R,1,D]
        x = layers.scale(x, scale=d_model ** 0.5)
        pos_t = layers.matmul(t_mask, pos_table)            # [R,D]
        x = layers.elementwise_add(x, layers.unsqueeze(pos_t, [1]))
        att_bias = None
        if not paged or not routed:
            # per-lane attention validity: positions past the step
            posf = layers.cast(positions, "float32")
            att_bias = layers.reshape(
                layers.scale(layers.cast(layers.greater_than(
                    posf, layers.cast(step2, "float32")), "float32"),
                    scale=-1e9),
                [rows, 1, 1, maxT])
        if not paged:
            write_mask = layers.reshape(t_mask, [rows, 1, maxT, 1])
            keep_mask = layers.reshape(
                layers.elementwise_sub(
                    layers.fill_constant([rows, maxT], "float32", 1.0),
                    t_mask),
                [rows, 1, maxT, 1])
            caches = [_DenseLaneCache(sv[f"{state_prefix}self_k{li}"],
                                      sv[f"{state_prefix}self_v{li}"],
                                      write_mask, keep_mask)
                      for li in range(n_layers)]
            cross_kv = [(sv[f"{state_prefix}cross_k{li}"],
                         sv[f"{state_prefix}cross_v{li}"])
                        for li in range(n_layers)]
        else:
            # cell of position p through the host-owned block table:
            # tab[lane, p // BS] * BS + p % BS
            tab = sv[f"{state_prefix}block_tab"]
            tabf = layers.cast(tab, "float32")              # [R,NP]
            offs = layers.assign(np.arange(BS, dtype="float32"))
            flat_pos = None
            if not routed:
                base = layers.expand(
                    layers.unsqueeze(layers.scale(tabf, scale=float(BS)),
                                     [2]),
                    [1, 1, BS])                             # [R,NP,BS]
                flat_posf = layers.elementwise_add(base, offs, axis=2)
                flat_pos = layers.cast(
                    layers.reshape(flat_posf, [rows * maxT]), "int32")
            # the current position's page and offset from t_mask
            t_pages = layers.reshape(t_mask, [rows, NP, BS])
            page_oh = layers.reduce_sum(t_pages, dim=2)     # [R,NP]
            off_oh = layers.reduce_sum(t_pages, dim=1)      # [R,BS]
            cur_block = layers.reduce_sum(
                layers.elementwise_mul(tabf, page_oh), dim=1)
            cur_off = layers.reduce_sum(
                layers.elementwise_mul(off_oh, offs), dim=1)
            write_idx = layers.cast(
                layers.elementwise_add(
                    layers.scale(cur_block, scale=float(BS)), cur_off),
                "int32")                                    # [R]
            # idle, dustbin and paused lanes (act=0) must not write the
            # shared pool
            gate = layers.cast(act, "float32")
            caches = [_PagedLaneCache(
                sv[f"{state_prefix}self_k{li}{POOL_MARK}"],
                sv[f"{state_prefix}self_v{li}{POOL_MARK}"],
                write_idx, gate, rows, n_heads, head_dim, maxT, NB * BS,
                tab, stepv, flat_pos=flat_pos) for li in range(n_layers)]
            cross_kv = _paged_cross_kv(sv)
        x = cached_decoder_step(x, caches, cross_kv, att_bias, d_model,
                                n_heads, d_inner)
        logits_v = layers.fc(layers.reshape(x, [0, d_model]), vocab,
                             bias_attr=False, param_attr="logits.w")
        if probe:
            # every lane's next-token distribution, for the host to
            # branch on (the beam decoder's expansion oracle)
            layers.assign(layers.softmax(logits_v),
                          output=sv[f"{state_prefix}probe_probs"])
        # per-lane emit (emit_token_step vectorized over lane counters;
        # same freeze and write semantics). A sampled lane draws from the
        # filtered distribution keyed on its seed and the position it
        # writes, whichever serve program runs the tick
        ones_n = layers.fill_constant([rows], "int64", 1.0)
        if sampling is not None and not sampling.greedy:
            probs_v = layers.filtered_softmax(
                logits_v, temperature=sampling.temperature,
                top_k=sampling.top_k, top_p=sampling.top_p)
            tok = layers.sample_categorical(
                probs_v, sv[f"{state_prefix}seed"],
                layers.elementwise_add(stepv, ones_n),
                noise_tag=0, base_seed=sampling.base_seed)   # [R]
        else:
            tok = layers.cast(layers.argmax(logits_v, axis=-1), "int64")
        not_fin = layers.elementwise_sub(ones_n, fin)
        tok = layers.elementwise_add(
            layers.elementwise_mul(tok, not_fin),
            layers.cast(layers.scale(fin, scale=float(end_id)), "int64"))
        # teacher forcing: while step+1 < prefill_until the lane replays
        # its history; the emitted token does not land and EOS does not
        # latch (prefill_until is 0 outside the radix tier)
        emit_flag = ones_n
        if paged:
            forcing = layers.elementwise_mul(
                act, layers.cast(layers.less_than(
                    layers.elementwise_add(stepv, ones_n),
                    sv[f"{state_prefix}prefill_until"]), "int64"))
            emit_flag = layers.elementwise_sub(ones_n, forcing)
        # the EOS latch only counts lanes that advanced this tick: a
        # host-paused lane decodes a garbage token it redoes on resume
        new_fin = layers.elementwise_max(
            fin, layers.elementwise_mul(
                layers.elementwise_mul(act, emit_flag),
                layers.cast(layers.equal(
                    tok, layers.fill_constant([1], "int64",
                                              float(end_id))),
                    "int64")))
        next2 = layers.reshape(layers.elementwise_add(stepv, ones_n),
                               [rows, 1])
        next_mask = layers.cast(layers.equal(positions, next2), "int64")
        next_mask = layers.elementwise_mul(
            next_mask, layers.reshape(emit_flag, [rows, 1]))
        keep_tok = layers.elementwise_sub(
            layers.fill_constant([rows, maxT], "int64", 1.0), next_mask)
        new_step = layers.elementwise_add(stepv, act)
        layers.assign(layers.elementwise_add(
            layers.elementwise_mul(tok_buf, keep_tok),
            layers.elementwise_mul(next_mask,
                                   layers.reshape(tok, [rows, 1]))),
            output=tok_buf)
        layers.assign(new_step, output=stepv)
        # lanes deactivate on EOS or a full buffer; the host retires a
        # lane the moment its active flag drops
        room = layers.cast(layers.less_than(
            new_step, layers.fill_constant([1], "int64",
                                           float(maxT - 1))), "int64")
        new_act = layers.elementwise_mul(
            layers.elementwise_mul(
                act, layers.elementwise_sub(ones_n, new_fin)), room)
        layers.assign(new_act, output=act)
        layers.assign(new_fin, output=fin)

    def _draft_step(sv, tok, stepj):
        """One cached draft-model step over every lane at position
        ``stepj`` from token ``tok`` [R,1]: the draft's KV at stepj is
        written; returns the [R,1,dd] hidden rows."""
        dd = draft.d_model
        positions = layers.cast(layers.range(0, maxT, 1), "int64")
        posf = layers.cast(positions, "float32")
        dpos_table = layers.assign(
            T._position_encoding(max(seq_len, maxT), dd)[:maxT])
        stepj2 = layers.reshape(stepj, [rows, 1])
        t_mask = layers.cast(layers.equal(positions, stepj2),
                             "float32")                     # [R,maxT]
        x = layers.embedding(tok, size=[vocab, dd], param_attr=ParamAttr(
            name=f"{draft.prefix}tgt_word_emb"))
        x = layers.scale(layers.unsqueeze(x, [1]), scale=dd ** 0.5)
        x = layers.elementwise_add(
            x, layers.unsqueeze(layers.matmul(t_mask, dpos_table), [1]))
        dbias = layers.reshape(
            layers.scale(layers.cast(layers.greater_than(
                posf, layers.cast(stepj2, "float32")), "float32"),
                scale=-1e9),
            [rows, 1, 1, maxT])
        wm = layers.reshape(t_mask, [rows, 1, maxT, 1])
        km = layers.reshape(
            layers.elementwise_sub(
                layers.fill_constant([rows, maxT], "float32", 1.0),
                t_mask), [rows, 1, maxT, 1])
        dcaches = [_DenseLaneCache(sv[f"{state_prefix}draft_self_k{li}"],
                                   sv[f"{state_prefix}draft_self_v{li}"],
                                   wm, km)
                   for li in range(draft.n_layers)]
        dcross = [(sv[f"{state_prefix}draft_cross_k{li}"],
                   sv[f"{state_prefix}draft_cross_v{li}"])
                  for li in range(draft.n_layers)]
        return cached_decoder_step(x, dcaches, dcross, dbias, dd,
                                   draft.n_heads, draft.d_inner,
                                   prefix=draft.prefix)

    def _ngram_propose(sv, tok_buf, step2, cur_tok, k):
        """The model-free proposer (prompt-lookup decoding): the
        rightmost occurrence of the lane's last-n-token suffix in
        prompt + history, strictly left of the live end, and its
        continuation; a proposal past the committed text falls back to
        the current token. Returns (proposals [R] each, one-hot draft
        rows [R,1,V] each): the verify's accept test is exact for a
        one-hot draft under greedy and sampled emission alike."""
        n = draft.ngram
        ctx_len = seq_len + maxT
        ctx_f = layers.cast(layers.concat(
            [sv[f"{state_prefix}prompt_toks"], tok_buf], axis=1),
            "float32")                                      # [R,CTX]
        ctx_posf = layers.assign(np.arange(ctx_len, dtype="float32"))
        step2f = layers.cast(step2, "float32")              # [R,1]
        # a match end j needs a full suffix left of it (j >= n-1) and
        # lies strictly left of the live end (j < S + step)
        j_ok = layers.cast(layers.greater_than(
            ctx_posf, layers.fill_constant([1], "float32",
                                           float(n - 2))), "float32")
        end_ok = layers.cast(layers.less_than(
            ctx_posf, layers.scale(step2f, bias=float(seq_len))),
            "float32")                                      # [R,CTX]
        score = layers.elementwise_mul(end_ok, j_ok, axis=1)
        for i in range(n):
            # suffix token i back from the live end, ctx[S + step - i],
            # against ctx shifted right by i
            m_i = layers.cast(layers.equal(
                ctx_posf, layers.scale(step2f, bias=float(seq_len - i))),
                "float32")
            s_i = layers.reduce_sum(layers.elementwise_mul(ctx_f, m_i),
                                    dim=1, keep_dim=True)   # [R,1]
            shifted = layers.matmul(ctx_f, layers.assign(
                np.eye(ctx_len, dtype="float32", k=i)))
            score = layers.elementwise_mul(score, layers.cast(
                layers.equal(shifted, s_i), "float32"))
        # the rightmost match end: max of score * (j + 1); 0 is none
        best = layers.reduce_max(
            layers.elementwise_mul(score, layers.scale(ctx_posf, bias=1.0),
                                   axis=1), dim=1, keep_dim=True)
        has = layers.cast(layers.greater_than(
            best, layers.fill_constant([1], "float32", 0.0)), "float32")
        idx = layers.scale(best, bias=-1.0)                 # [R,1]
        cur_f = layers.cast(cur_tok, "float32")
        proposals, dprob_rows = [], []
        for m in range(k):
            pm = layers.scale(idx, bias=float(1 + m))
            # the proposed position must itself be committed text
            ok_m = layers.elementwise_mul(has, layers.cast(
                layers.less_than(pm, layers.scale(
                    step2f, bias=float(seq_len + 1))), "float32"))
            got = layers.reduce_sum(layers.elementwise_mul(
                ctx_f, layers.cast(layers.equal(ctx_posf, pm),
                                   "float32")), dim=1, keep_dim=True)
            tok_m = layers.cast(layers.reshape(
                layers.elementwise_add(
                    layers.elementwise_mul(got, ok_m),
                    layers.elementwise_mul(
                        cur_f, layers.scale(ok_m, scale=-1.0, bias=1.0))),
                [rows]), "int64")                           # [R]
            proposals.append(tok_m)
            dprob_rows.append(layers.unsqueeze(
                layers.one_hot(tok_m, vocab), [1]))         # [R,1,V]
        return proposals, dprob_rows

    def _model_propose(sv, stepv, cur_tok, k):
        """k+1 unrolled cached draft steps over positions step..step+k.
        Steps 0..k-1 propose; step k only writes the draft's KV at
        step+k. Without it a full-acceptance tick advances the lane past
        a position the draft never processed, a hole its cache keeps for
        the lane's lifetime, and acceptance collapses after the first
        burst while the tokens stay right."""
        proposals, dprob_rows = [], []
        prev = cur_tok
        for j in range(k + 1):
            stepj = stepv if j == 0 else layers.elementwise_add(
                stepv, layers.fill_constant([1], "int64", float(j)))
            x = _draft_step(sv, prev, stepj)
            if j == k:
                break
            dlogits = layers.fc(layers.reshape(x, [0, draft.d_model]),
                                vocab, bias_attr=False,
                                param_attr=f"{draft.prefix}logits.w")
            dprobs = layers.filtered_softmax(
                dlogits, temperature=samp.temperature, top_k=samp.top_k,
                top_p=samp.top_p)
            if greedy:
                tok_j = layers.cast(layers.argmax(dprobs, axis=-1),
                                    "int64")
            else:
                tok_j = layers.sample_categorical(
                    dprobs, sv[f"{state_prefix}seed"],
                    layers.elementwise_add(
                        stepj, layers.fill_constant([1], "int64", 1.0)),
                    noise_tag=1, base_seed=samp.base_seed)
            proposals.append(tok_j)
            dprob_rows.append(layers.unsqueeze(dprobs, [1]))
            prev = layers.reshape(tok_j, [rows, 1])
        return proposals, dprob_rows

    def _spec_step_body(sv, k_run=None):
        """The speculative tick (``decode_engine.py:2412`` in the JAX
        package): propose k tokens a lane, verify [current token, k
        proposals] in one Q = k+1-query target step over the span caches,
        then ``spec_accept``, the accepted run's token write and the
        counters. KV cells past the accepted prefix hold rejected-token
        values, which the per-query bias masks and the lane rewrites
        when it gets there. ``k_run``: this ladder rung's k."""
        k = draft.k if k_run is None else int(k_run)
        Q = k + 1
        tok_buf = sv[f"{state_prefix}tok_buf"]
        stepv = sv[f"{state_prefix}step"]
        fin = sv[f"{state_prefix}finished"]
        act = sv[f"{state_prefix}active"]
        seedv = sv[f"{state_prefix}seed"]
        _tel_add(sv, "tel_ticks", layers.fill_constant([1], "int64", 1.0))
        _tel_add(sv, "tel_occupancy", layers.reduce_sum(act,
                                                        keep_dim=True))
        # which rung ticked (a fixed-k bundle carries no such counter)
        _tel_add(sv, devtel.spec_k_logical(k),
                 layers.fill_constant([1], "int64", 1.0))
        positions = layers.cast(layers.range(0, maxT, 1), "int64")
        posf = layers.cast(positions, "float32")
        pos_table = layers.assign(
            T._position_encoding(max(seq_len, maxT), d_model)[:maxT])
        ones_n = layers.fill_constant([rows], "int64", 1.0)
        step2 = layers.reshape(stepv, [rows, 1])            # [R,1]
        t_mask0 = layers.cast(layers.equal(positions, step2), "float32")
        cur_tok = layers.reduce_sum(
            layers.elementwise_mul(tok_buf, layers.cast(t_mask0, "int64")),
            dim=1, keep_dim=True)                           # [R,1]
        if ngram:
            proposals, dprob_rows = _ngram_propose(sv, tok_buf, step2,
                                                   cur_tok, k)
        else:
            proposals, dprob_rows = _model_propose(sv, stepv, cur_tok, k)

        # the target's verify over [current token, k proposals]
        toks_q = layers.concat(
            [cur_tok] + [layers.reshape(t, [rows, 1]) for t in proposals],
            axis=1)                                         # [R,Q]
        x = layers.embedding(toks_q, size=[vocab, d_model],
                             param_attr=ParamAttr(name="tgt_word_emb"))
        x = layers.scale(x, scale=d_model ** 0.5)           # [R,Q,D]
        posq = layers.elementwise_add(
            step2, layers.assign(np.arange(Q).astype("int64")))
        posq3 = layers.reshape(posq, [rows, Q, 1])
        t_mask_q = layers.cast(layers.equal(positions, posq3),
                               "float32")                   # [R,Q,maxT]
        x = layers.elementwise_add(x, layers.matmul(t_mask_q, pos_table))
        # query j attends positions <= step+j; a position past the
        # buffer has an all-zero one-hot and writes nothing
        bias = layers.reshape(
            layers.scale(layers.cast(layers.greater_than(
                posf, layers.cast(posq3, "float32")), "float32"),
                scale=-1e9),
            [rows, 1, Q, maxT])
        if not paged:
            keep = layers.reshape(
                layers.elementwise_sub(
                    layers.fill_constant([rows, maxT], "float32", 1.0),
                    layers.reduce_sum(t_mask_q, dim=1)),
                [rows, 1, maxT, 1])
            caches = [_DenseSpanCache(sv[f"{state_prefix}self_k{li}"],
                                      sv[f"{state_prefix}self_v{li}"],
                                      t_mask_q, keep)
                      for li in range(n_layers)]
            cross_kv = [(sv[f"{state_prefix}cross_k{li}"],
                         sv[f"{state_prefix}cross_v{li}"])
                        for li in range(n_layers)]
        else:
            tabf = layers.cast(sv[f"{state_prefix}block_tab"], "float32")
            base = layers.expand(
                layers.unsqueeze(layers.scale(tabf, scale=float(BS)), [2]),
                [1, 1, BS])                                 # [R,NP,BS]
            offs = layers.assign(np.arange(BS, dtype="float32"))
            flat_pos = layers.cast(layers.reshape(
                layers.elementwise_add(base, offs, axis=2),
                [rows * maxT]), "int32")
            t_pages_q = layers.reshape(t_mask_q, [rows, Q, NP, BS])
            page_oh = layers.reduce_sum(t_pages_q, dim=3)   # [R,Q,NP]
            off_oh = layers.reduce_sum(t_pages_q, dim=2)    # [R,Q,BS]
            cur_block = layers.reduce_sum(
                layers.elementwise_mul(layers.unsqueeze(tabf, [1]),
                                       page_oh), dim=2)     # [R,Q]
            cur_off = layers.reduce_sum(
                layers.elementwise_mul(off_oh, offs), dim=2)
            write_idx = layers.cast(layers.reshape(
                layers.elementwise_add(
                    layers.scale(cur_block, scale=float(BS)), cur_off),
                [rows * Q]), "int32")
            # gate = active AND position in the buffer: an out-of-range
            # query's all-zero one-hot would alias cell 0 of block 0,
            # another lane's KV
            validq = layers.reduce_sum(t_mask_q, dim=2)     # [R,Q]
            gate = layers.reshape(layers.elementwise_mul(
                layers.reshape(layers.cast(act, "float32"), [rows, 1]),
                validq), [rows * Q])
            caches = [_PagedSpanCache(
                sv[f"{state_prefix}self_k{li}{POOL_MARK}"],
                sv[f"{state_prefix}self_v{li}{POOL_MARK}"],
                write_idx, gate, flat_pos, rows, Q, n_heads, head_dim,
                maxT, NB * BS) for li in range(n_layers)]
            cross_kv = _paged_cross_kv(sv)
        x = cached_decoder_step(x, caches, cross_kv, bias, d_model,
                                n_heads, d_inner, q=Q)      # [R,Q,D]
        logits_q = layers.fc(x, vocab, num_flatten_dims=2,
                             bias_attr=False, param_attr="logits.w")
        tprobs = layers.filtered_softmax(
            logits_q, temperature=samp.temperature, top_k=samp.top_k,
            top_p=samp.top_p)                               # [R,Q,V]
        adv, toks, accepted, fin_new = layers.spec_accept(
            layers.concat([layers.reshape(t, [rows, 1])
                           for t in proposals], axis=1),
            layers.concat(dprob_rows, axis=1), tprobs, seedv, stepv, k=k,
            end_id=end_id, max_len=maxT, greedy=greedy,
            base_seed=samp.base_seed, noise_tag=8)
        adv_g = layers.elementwise_mul(adv, act)            # [R]
        layers.span_scatter(tok_buf, toks,
                            layers.elementwise_add(stepv, ones_n), adv_g)
        new_fin = layers.elementwise_max(
            fin, layers.elementwise_mul(fin_new, act))
        new_step = layers.elementwise_add(stepv, adv_g)
        room = layers.cast(layers.less_than(
            new_step, layers.fill_constant([1], "int64",
                                           float(maxT - 1))), "int64")
        new_act = layers.elementwise_mul(
            layers.elementwise_mul(
                act, layers.elementwise_sub(ones_n, new_fin)), room)
        # the counters read this tick's act: summed before the in-place
        # act update below
        live = layers.reduce_sum(act, keep_dim=True)
        k_const = layers.fill_constant([1], "int64", float(k))
        acc_live = layers.elementwise_mul(accepted, act)
        bumps = [("spec_proposed", layers.elementwise_mul(live, k_const)),
                 ("spec_accepted", layers.reduce_sum(acc_live,
                                                     keep_dim=True)),
                 ("spec_emitted", layers.reduce_sum(adv_g,
                                                    keep_dim=True)),
                 ("spec_target_steps",
                  layers.fill_constant([1], "int64", 1.0))]
        if not ngram:
            # the n-gram lane runs no draft-model step
            bumps.append(("spec_draft_steps", k_const))
        bumps += [("spec_lane_accepted", acc_live),
                  ("spec_lane_ticks", act)]
        for name, delta in bumps:
            var = sv[f"{state_prefix}{name}"]
            layers.assign(layers.elementwise_add(var, delta), output=var)
        layers.assign(new_step, output=stepv)
        layers.assign(new_act, output=act)
        layers.assign(new_fin, output=fin)

    def _k0_body(sv):
        """The ladder's k = 0 rung: the plain step, after one draft step
        at the current position for a model draft (the keepalive: a lane
        parked at k = 0 must not leave holes in the draft's cache for a
        later rung to propose from). The spec counters do not move; the
        rung's tick counter does."""
        if draft.kind == "model":
            tok_buf = sv[f"{state_prefix}tok_buf"]
            stepv = sv[f"{state_prefix}step"]
            positions = layers.cast(layers.range(0, maxT, 1), "int64")
            t_mask = layers.cast(layers.equal(
                positions, layers.reshape(stepv, [rows, 1])), "int64")
            cur_tok = layers.reduce_sum(
                layers.elementwise_mul(tok_buf, t_mask), dim=1,
                keep_dim=True)
            _draft_step(sv, cur_tok, stepv)
        _step_body(sv)
        _tel_add(sv, devtel.spec_k_logical(0),
                 layers.fill_constant([1], "int64", 1.0))

    body = _spec_step_body if spec else _step_body

    step_prog = Program()
    with program_guard(step_prog, Program()):
        body(_declare_slot_state(step_prog.global_block, specs))

    def _build_serve(tier, A, step_body=None):
        def pre(sv):
            if A > 0:
                admit_bodies[tier](sv, A)
        return _serve_program(pre, step_body)

    def _serve_program(pre_body, step_body=None):
        """`pre_body` (an admission, a prefill chunk, or nothing) and then
        a decode-burst While of `step_body` (the bundle's tick body
        unless a ladder rung names its own): the loop exits when n_steps
        ticks ran or the live-lane count drops to min_active."""
        step_body = body if step_body is None else step_body
        prog = Program()
        with program_guard(prog, Program()):
            sv = _declare_slot_state(prog.global_block, specs)
            pre_body(sv)
            n_steps = layers.data("n_steps", shape=[1], dtype="int64",
                                  append_batch_size=False)
            min_active = layers.data("min_active", shape=[1],
                                     dtype="int64",
                                     append_batch_size=False)
            act = sv[f"{state_prefix}active"]
            k = layers.fill_constant([1], "int64", 0)

            def _serve_cond(cond=None):
                # ticks remain and live lanes exceed the exit threshold
                return layers.greater_than(
                    layers.elementwise_min(
                        layers.elementwise_sub(n_steps, k),
                        layers.elementwise_sub(
                            layers.reduce_sum(act, keep_dim=True),
                            min_active)),
                    layers.fill_constant([1], "int64", 0.0), cond=cond)

            cond = _serve_cond()
            w = layers.While(cond)
            with w.block():
                step_body(sv)
                layers.increment(k, 1)
                _serve_cond(cond=cond)
            # classify this burst's exit once: ran all n_steps ticks >
            # every lane idle > live dropped to min_active
            ran_out = layers.cast(layers.equal(k, n_steps), "int64")
            live = layers.reduce_sum(act, keep_dim=True)
            idle = layers.cast(
                layers.equal(live,
                             layers.fill_constant([1], "int64", 0.0)),
                "int64")
            one = layers.fill_constant([1], "int64", 1.0)
            not_ran = layers.elementwise_sub(one, ran_out)
            _tel_add(sv, "tel_exit_n_steps", ran_out)
            _tel_add(sv, "tel_exit_all_idle",
                     layers.elementwise_mul(not_ran, idle))
            _tel_add(sv, "tel_exit_min_active",
                     layers.elementwise_mul(
                         not_ran, layers.elementwise_sub(one, idle)))
        return prog

    def _chunk_phase_body(sv, p):
        """Phase p of a cold prompt's encoder over C prompt positions
        from ``chunk_pos`` (``decode_engine.py:2964`` in the JAX package).
        Phases: 0 embeds the chunk and adds the positional table into
        stage a; 1 + 2l stages layer l's self-attention K and V of the
        chunk; 2 + 2l runs the chunk's C queries over the layer's K and V
        at every position (kernel #2 on the card when C > 512), then the
        encoder tail, into the other stage; 2L + 1 projects the chunk's
        cross K/V for every decoder layer into the prompt entry's cross
        pools. Outside ``layers.attention`` every op is per position, and
        attention reads complete staged K/V, so the walk writes the
        monolithic miss admission's cross-KV rows. A merge replaces the
        chunk's positions of the entry's row and keeps the others: the
        one-hot products select exactly (one nonzero a column, fp32 with
        TF32 off), and the ragged last chunk's rows past seq_len select
        nothing, so its zero padding never lands."""
        C, S, L = cache.chunk_tokens, seq_len, n_layers
        entry = layers.data("chunk_entry", shape=[1], dtype="int64",
                            append_batch_size=False)
        pos0 = layers.data("chunk_pos", shape=[1], dtype="int64",
                           append_batch_size=False)
        # one chunk ran; how many decode lanes were live while it did
        _tel_add(sv, "tel_chunks", layers.fill_constant([1], "int64", 1.0))
        _tel_add(sv, "tel_prefill_occupancy",
                 layers.reduce_sum(sv[f"{state_prefix}active"],
                                   keep_dim=True))
        # [C, S] chunk-position one-hot: row c selects position pos0 + c
        sr = layers.cast(layers.range(0, S, 1), "int64")
        cr = layers.cast(layers.range(0, C, 1), "int64")
        csel = layers.cast(
            layers.equal(sr, layers.elementwise_add(
                layers.reshape(cr, [C, 1]), pos0)), "float32")
        cselT = layers.transpose(csel, perm=[1, 0])        # [S, C]
        keep = layers.reshape(
            layers.elementwise_sub(
                layers.fill_constant([S], "float32", 1.0),
                layers.reduce_sum(csel, dim=0)), [S, 1])
        stage = [sv[f"{state_prefix}chunk_stage_a{POOL_MARK}"],
                 sv[f"{state_prefix}chunk_stage_b{POOL_MARK}"]]
        stage_kv = sv[f"{state_prefix}chunk_stage_kv{POOL_MARK}"]

        def _stage_row(pool, width):                       # [S, width]
            return layers.reshape(layers.gather(pool, entry), [S, width])

        def _chunk_of(row, width):                         # [1, C, width]
            return layers.reshape(layers.matmul(csel, row), [1, C, width])

        def _stage_merge(pool, row, chunk2d):
            merged = layers.elementwise_add(
                layers.elementwise_mul(row, keep),
                layers.matmul(cselT, chunk2d))
            layers.masked_pool_write(
                pool, layers.unsqueeze(merged, [0]), entry,
                leading_dims=1, exclusive_via="host_indices")

        if p == 0:
            toks = layers.data("chunk_toks", shape=[1, C], dtype="int64",
                               append_batch_size=False)
            emb = layers.embedding(toks, size=[vocab, d_model],
                                   param_attr=ParamAttr(
                                       name="src_word_emb"))
            emb = layers.reshape(emb, [1, C, d_model])
            emb = layers.scale(emb, scale=d_model ** 0.5)
            pos_tab = layers.assign(
                T._position_encoding(max(S, maxT), d_model)[:S])
            x = layers.elementwise_add(
                emb, layers.matmul(csel, pos_tab), axis=1)
            _stage_merge(stage[0], _stage_row(stage[0], d_model),
                         layers.reshape(x, [C, d_model]))
            return
        if p <= 2 * L:
            l = (p - 1) // 2
            xrow = _stage_row(stage[l % 2], d_model)
            x = _chunk_of(xrow, d_model)
            # encoder_layer's fused qkv parameter
            qkv = layers.fc(x, 3 * d_model, num_flatten_dims=2,
                            bias_attr=False,
                            param_attr=T._attn_proj_attr(
                                f"enc{l}_self", "qkv", d_model))
            q, k, v = layers.split(qkv, 3, dim=2)
            if (p - 1) % 2 == 0:
                # K/V phase: stage the chunk's K and V (the next phase
                # recomputes q)
                _stage_merge(
                    stage_kv, _stage_row(stage_kv, 2 * d_model),
                    layers.reshape(layers.concat([k, v], axis=2),
                                   [C, 2 * d_model]))
                return
            kvrow = _stage_row(stage_kv, 2 * d_model)      # [S, 2D]
            kf, vf = layers.split(kvrow, 2, dim=1)
            q4 = layers.reshape(q, [0, 0, n_heads, head_dim])
            k4 = layers.reshape(kf, [1, S, n_heads, head_dim])
            v4 = layers.reshape(vf, [1, S, n_heads, head_dim])
            ctx = layers.attention(q4, k4, v4, causal=False,
                                   scale=head_dim ** -0.5,
                                   dropout_rate=0.0, layout="bthd")
            ctx = layers.reshape(ctx, [0, 0, d_model])
            attn = layers.fc(ctx, d_model, num_flatten_dims=2,
                             bias_attr=False,
                             param_attr=f"enc{l}_self_out.w")
            x1 = T._add_norm(attn, x, 0.0, True, name=f"enc{l}_a")
            ffn = T._ffn(x1, d_model, d_inner, 0.0, True, name=f"enc{l}")
            x2 = T._add_norm(ffn, x1, 0.0, True, name=f"enc{l}_b")
            out_pool = stage[(l + 1) % 2]
            _stage_merge(out_pool, _stage_row(out_pool, d_model),
                         layers.reshape(x2, [C, d_model]))
            return
        # the last phase: the entry's layout is heads_of's [H, S, Dh], so
        # the positional merge runs in a [S, H*Dh] view
        xrow = _stage_row(stage[L % 2], d_model)
        x = _chunk_of(xrow, d_model)
        for li in range(n_layers):
            kvp = layers.fc(x, 2 * d_model, num_flatten_dims=2,
                            bias_attr=False,
                            param_attr=T._attn_proj_attr(
                                f"dec{li}_cross", "kv", d_model))
            k, v = layers.split(kvp, 2, dim=2)
            for tag, val in (("k", k), ("v", v)):
                pool = sv[f"{state_prefix}cross_{tag}{li}{POOL_MARK}"]
                row = layers.reshape(
                    layers.transpose(layers.gather(pool, entry),
                                     perm=[0, 2, 1, 3]), [S, d_model])
                merged = layers.elementwise_add(
                    layers.elementwise_mul(row, keep),
                    layers.matmul(cselT,
                                  layers.reshape(val, [C, d_model])))
                layers.masked_pool_write(
                    pool,
                    layers.transpose(
                        layers.reshape(merged,
                                       [1, S, n_heads, head_dim]),
                        perm=[0, 2, 1, 3]),
                    entry, leading_dims=1, exclusive_via="host_indices")

    serves = {0: _build_serve("miss", 0)}
    for A in admit_buckets:
        if paged:
            serves[("miss", A)] = _build_serve("miss", A)
            serves[("hit", A)] = _build_serve("hit", A)
            if "radix" in admit_bodies:
                serves[("radix", A)] = _build_serve("radix", A)
        else:
            serves[A] = _build_serve("miss", A)
    if cache.chunked:
        # one serve program a phase, each the chunk followed by key 0's
        # decode While: live lanes keep ticking while a prompt prefills
        for p in range(2 * n_layers + 2):
            serves[("chunked", p)] = _serve_program(
                lambda sv, _p=p: _chunk_phase_body(sv, _p))
    if spec and draft.k_options:
        # the adaptive ladder: every other rung rebuilds each admission
        # flavor and bucket with its own tick body over the same slot
        # state, so the controller switches rungs by choosing a program
        base_keys = [bk for bk in serves
                     if not (isinstance(bk, tuple) and bk[0] == "chunked")]
        for kv in draft.k_options:
            if kv == draft.k:
                continue
            kv_body = _k0_body if kv == 0 else (
                lambda sv, _k=kv: _spec_step_body(sv, _k))
            for bk in base_keys:
                tier, A = (bk, 0) if bk == 0 else (
                    ("miss", bk) if isinstance(bk, int) else bk)
                serves[("k", kv, bk)] = _build_serve(tier, A,
                                                     step_body=kv_body)

    cow_prog = probe_prog = None
    if paged:
        # COW block copy: gather the shared source blocks of every self
        # pool and write them into fresh exclusive blocks, the one way a
        # lane diverges from a shared chain (beam branching). Padded
        # rows feed gate 0 and destination -1, so one fixed-shape
        # program serves any copy count.
        cow_prog = Program()
        with program_guard(cow_prog, Program()):
            sv = _declare_slot_state(cow_prog.global_block, specs)
            csrc = layers.data("cow_src", shape=[rows], dtype="int64",
                               append_batch_size=False)
            cdst = layers.data("cow_dst", shape=[rows], dtype="int64",
                               append_batch_size=False)
            cgate = layers.data("cow_gate", shape=[rows],
                                dtype="float32", append_batch_size=False)
            for li in range(n_layers):
                for tag in ("k", "v"):
                    pool = sv[f"{state_prefix}self_{tag}{li}{POOL_MARK}"]
                    layers.masked_pool_write(
                        pool, layers.gather(pool, csrc), cdst, cgate,
                        leading_dims=1, exclusive_via="cow_dst")
            _tel_add(sv, "tel_cow_blocks",
                     layers.reduce_sum(layers.cast(cgate, "int64"),
                                       keep_dim=True))
    if paged and not spec:
        # probe step: one tick that also publishes every lane's softmax
        # row; under teacher forcing over the whole buffer it never
        # writes tok_buf or latches fin (the host owns the tokens)
        probe_prog = Program()
        with program_guard(probe_prog, Program()):
            _step_body(_declare_slot_state(probe_prog.global_block,
                                           specs), probe=True)

    state = {"tok_buf": f"{state_prefix}tok_buf",
             "step": f"{state_prefix}step",
             "finished": f"{state_prefix}finished",
             "active": f"{state_prefix}active"}
    if paged:
        state["block_tab"] = f"{state_prefix}block_tab"
        state["prompt_ref"] = f"{state_prefix}prompt_ref"
        state["prefill_until"] = f"{state_prefix}prefill_until"
        if probe_prog is not None:
            state["probe_probs"] = f"{state_prefix}probe_probs"
    if needs_seeds:
        state["seed"] = f"{state_prefix}seed"
    if spec:
        for c in ("spec_proposed", "spec_accepted", "spec_emitted",
                  "spec_draft_steps", "spec_target_steps",
                  "spec_lane_accepted", "spec_lane_ticks"):
            state[c] = f"{state_prefix}{c}"
        if draft.k_options:
            state.update(devtel.spec_k_state_entries(state_prefix,
                                                     draft.k_options))
    state.update(devtel.state_entries(state_prefix, paged))
    bundle = DecodeStepBundle(prefills, step_prog, serves, startup, state,
                              n_slots, seq_len, maxT, start_id, end_id,
                              cache=cache, hit_prefills=hit_prefills,
                              sampling=sampling, draft=draft,
                              cow=cow_prog, probe=probe_prog)
    bundle._state_specs = dict(specs)
    return bundle


# ---------------------------------------------------------------------------
# Host-side allocation of the paged layout.
# ---------------------------------------------------------------------------
class HostBlockPool:
    """Free list over the ``n_blocks`` shared self-KV blocks, run as a
    typestate machine on per-block refcounts: ``free -> exclusive
    (refcount 1, one lane) -> shared (refcount > 1, read-only) ->
    free``. Invalid transitions raise ``BlockLifetimeError`` instead of
    corrupting the free list (a double-freed block would be handed to
    two lanes)."""

    def __init__(self, n_blocks: int):
        self.n_blocks = int(n_blocks)
        self._free = list(range(self.n_blocks))
        self._state = ["free"] * self.n_blocks
        self._refs = [0] * self.n_blocks

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        b = self._free.pop()
        self._state[b] = "exclusive"
        self._refs[b] = 1
        return b

    def free(self, blocks):
        """Single-owner free, legal only from 'exclusive'; checked for
        every block before any is freed."""
        blocks = list(blocks)
        seen = set()
        for b in blocks:
            if not 0 <= b < self.n_blocks:
                raise BlockLifetimeError(
                    f"free of block {b} outside the pool "
                    f"[0, {self.n_blocks})")
            if self._state[b] != "exclusive" or b in seen:
                state = ("freed-in-this-call" if b in seen
                         else repr(self._state[b]))
                raise BlockLifetimeError(
                    f"free of block {b} in typestate {state} (legal only "
                    f"from 'exclusive'): double-free/unallocated/shared "
                    f"free would hand one block to two lanes")
            seen.add(b)
        for b in blocks:
            self._state[b] = "free"
            self._refs[b] = 0
            self._free.append(b)

    def incref(self, block: int) -> int:
        """A new reader adopts the block: 1 -> 2 is exclusive -> shared."""
        if not 0 <= block < self.n_blocks:
            raise BlockLifetimeError(
                f"incref of block {block} outside the pool "
                f"[0, {self.n_blocks})")
        if self._refs[block] <= 0:
            raise BlockLifetimeError(
                f"incref of block {block} in typestate "
                f"{self._state[block]!r} (refcount 0): a freed block "
                f"may be re-handed to another lane at any alloc")
        self._refs[block] += 1
        self._state[block] = "shared"
        return self._refs[block]

    def decref(self, block: int) -> int:
        """Drop one reference; at 0 the block returns to the free list."""
        if not 0 <= block < self.n_blocks:
            raise BlockLifetimeError(
                f"decref of block {block} outside the pool "
                f"[0, {self.n_blocks})")
        if self._refs[block] <= 0:
            raise BlockLifetimeError(
                f"decref of block {block} at refcount "
                f"{self._refs[block]}: refcounts never go negative")
        self._refs[block] -= 1
        if self._refs[block] == 0:
            self._state[block] = "free"
            self._free.append(block)
        elif self._refs[block] == 1:
            self._state[block] = "exclusive"
        return self._refs[block]

    def refcount(self, block: int) -> int:
        return self._refs[block]

    def writable(self, block: int) -> bool:
        """A device write into the block is legal only at refcount 1."""
        return self._refs[block] == 1

    def typestate(self, block: int) -> str:
        return self._state[block]

    def live_blocks(self) -> set:
        return {b for b, s in enumerate(self._state) if s != "free"}

    def shared_blocks(self) -> set:
        return {b for b, s in enumerate(self._state) if s == "shared"}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_blocks - len(self._free)


class PromptPrefixCache:
    """Refcounted exact-prompt cache over the cross-KV entry pool. The
    encoder is bidirectional, so a cross-KV entry depends on the whole
    prompt and only a full match reuses it; a prompt whose leading
    chunk matches a cached one is the ``partial`` tier, encoded anew
    like a miss and counted as a copy. Entries are pinned while a lane
    refers to them; unpinned entries stay cached and are evicted, least
    recently used first, only when a miss needs a slot."""

    def __init__(self, n_entries: int, chunk_tokens: int):
        self.n_entries = int(n_entries)
        self.chunk = max(1, int(chunk_tokens))
        self._free = list(range(self.n_entries))
        self._by_prompt: Dict[tuple, int] = {}
        self._entry_prompt: Dict[int, tuple] = {}
        self._refs: Dict[int, int] = {}
        self._lru: Dict[tuple, None] = {}      # insertion-ordered
        self._heads: Dict[tuple, int] = {}     # first chunk -> count
        self.hits = 0
        self.misses = 0
        self.partials = 0       # exposed as cow_copies
        self.evictions = 0

    def _head(self, prompt: tuple) -> tuple:
        return prompt[:self.chunk]

    def lookup(self, prompt: tuple) -> Tuple[str, Optional[int]]:
        """('hit', entry), ('partial', None) or ('miss', None); no
        counter or refcount moves."""
        entry = self._by_prompt.get(prompt)
        if entry is not None:
            return "hit", entry
        if self._heads.get(self._head(prompt)):
            return "partial", None
        return "miss", None

    def acquire_hit(self, prompt: tuple) -> int:
        entry = self._by_prompt[prompt]
        self._refs[entry] = self._refs.get(entry, 0) + 1
        self._lru.pop(prompt, None)
        self._lru[prompt] = None
        self.hits += 1
        return entry

    def acquire_fresh(self, prompt: tuple,
                      partial: bool = False) -> Optional[int]:
        """An entry for a cold prompt: a free one, else the least
        recently used unpinned one (evicted). None when every entry is
        pinned."""
        if self._free:
            entry = self._free.pop()
        else:
            victim = next((p for p in self._lru
                           if self._refs.get(self._by_prompt[p], 0) == 0),
                          None)
            if victim is None:
                return None
            entry = self._by_prompt.pop(victim)
            self._lru.pop(victim, None)
            self._entry_prompt.pop(entry, None)
            self._drop_head(victim)
            self.evictions += 1
        self._by_prompt[prompt] = entry
        self._entry_prompt[entry] = prompt
        self._refs[entry] = 1
        self._lru[prompt] = None
        head = self._head(prompt)
        self._heads[head] = self._heads.get(head, 0) + 1
        if partial:
            self.partials += 1
        else:
            self.misses += 1
        return entry

    def _drop_head(self, prompt):
        head = self._head(prompt)
        self._heads[head] -= 1
        if not self._heads[head]:
            del self._heads[head]

    def release(self, entry: int):
        refs = self._refs.get(entry, 0)
        if refs <= 0:
            raise BlockLifetimeError(
                f"release of prompt entry {entry} at refcount {refs}: "
                f"a double release would unpin an entry another lane "
                f"still attends to")
        self._refs[entry] = refs - 1

    def invalidate(self, entry: int):
        """Forget an unpinned entry's prompt and free its slot (an
        abandoned, part-written prefill must never be hit)."""
        if self._refs.get(entry, 0) > 0:
            raise BlockLifetimeError(
                f"invalidate of prompt entry {entry} at refcount "
                f"{self._refs[entry]}: release every ref first")
        prompt = self._entry_prompt.pop(entry, None)
        if prompt is None:
            return
        del self._by_prompt[prompt]
        self._lru.pop(prompt, None)
        self._drop_head(prompt)
        self._refs.pop(entry, None)
        self._free.append(entry)

    def refcount(self, entry: int) -> int:
        return self._refs.get(entry, 0)

    def is_shared(self, entry: int) -> bool:
        return self.refcount(entry) > 1

    def writable(self, entry: int) -> bool:
        return self.refcount(entry) <= 1

    def typestate(self, entry: int) -> str:
        refs = self.refcount(entry)
        if refs == 0:
            return "free"
        return "exclusive" if refs == 1 else "shared"

    @property
    def in_use(self) -> int:
        return sum(1 for r in self._refs.values() if r > 0)


class _RadixNode:
    __slots__ = ("chunk", "block", "children", "parent")

    def __init__(self, chunk, block, parent):
        self.chunk = chunk        # the BS-token tuple this edge spells
        self.block = block        # pool block holding its self-KV
        self.children = {}        # chunk tuple -> _RadixNode
        self.parent = parent


class RadixBlockTree:
    """Host-side radix tree from decoded-token chunks to self-KV blocks
    (``decode_engine.py:3753`` in the JAX package; the longest shared
    prefix of SGLang's RadixAttention over vLLM-style block tables).

    Granularity is one full block (``block_size`` tokens): a node is a
    block whose KV is fixed by the root prompt and the token chunks
    spelling the path to it. Roots are keyed by the prompt's content:
    the encoder is bidirectional, so every self-KV row also attends
    cross-attention values of the whole prompt, and only requests with
    the same prompt share chains.

    Refcounts live in the ``HostBlockPool``: the tree holds one ref per
    adopted node (``insert``), and every lane that maps a chain
    read-only holds one ref per block (``acquire`` / ``release``). A
    node whose block is at refcount 1 is tree-only; ``evict`` drops
    such leaves, never an interior node (its children's KV depends on
    it)."""

    def __init__(self, pool: HostBlockPool, block_size: int):
        self.pool = pool
        self.block_size = max(1, int(block_size))
        self._roots: Dict[tuple, _RadixNode] = {}
        self.inserts = 0
        self.adoptions = 0
        self.hit_blocks = 0
        self.evicted_blocks = 0

    def _chunks(self, tokens):
        toks = tuple(int(t) for t in tokens)
        bs = self.block_size
        return [toks[i:i + bs]
                for i in range(0, len(toks) - len(toks) % bs, bs)]

    def _walk(self, prompt, tokens):
        """The matched nodes of the longest-prefix walk."""
        node = self._roots.get(tuple(int(t) for t in prompt))
        path = []
        if node is None:
            return path
        for chunk in self._chunks(tokens):
            nxt = node.children.get(chunk)
            if nxt is None:
                break
            path.append(nxt)
            node = nxt
        return path

    def match(self, prompt, tokens) -> int:
        """Longest shared prefix, in blocks, of this (prompt, tokens)
        pair; no refcount moves."""
        return len(self._walk(prompt, tokens))

    def acquire(self, prompt, tokens, max_blocks=None):
        """Map the longest shared prefix (at most ``max_blocks``) into a
        lane: one ``incref`` per block. Returns the blocks, shallowest
        first."""
        path = self._walk(prompt, tokens)
        if max_blocks is not None:
            path = path[:max_blocks]
        blocks = [n.block for n in path]
        for b in blocks:
            self.pool.incref(b)
        self.hit_blocks += len(blocks)
        return blocks

    def release(self, blocks):
        """Drop a lane's refs on a chain, deepest first."""
        for b in reversed(list(blocks)):
            self.pool.decref(b)

    def insert(self, prompt, tokens, blocks) -> int:
        """Adopt a retiring lane's full-block chain. Where a node exists
        the existing block wins (the lane's copy stays lane-owned and is
        freed with the lane); elsewhere the tree adopts the lane's block
        with its own ``incref``. Returns the blocks newly adopted."""
        key = tuple(int(t) for t in prompt)
        chunks = self._chunks(tokens)
        if not chunks:
            return 0
        blocks = list(blocks)
        if len(blocks) < len(chunks):
            raise BlockLifetimeError(
                f"radix insert of {len(chunks)} full chunks backed by "
                f"only {len(blocks)} blocks: a node without its KV block "
                f"would serve garbage to every later hit")
        root = self._roots.get(key)
        if root is None:
            root = self._roots[key] = _RadixNode(None, None, None)
        node, adopted = root, 0
        for chunk, block in zip(chunks, blocks):
            nxt = node.children.get(chunk)
            if nxt is None:
                self.pool.incref(block)
                nxt = _RadixNode(chunk, block, node)
                node.children[chunk] = nxt
                adopted += 1
            node = nxt
        self.inserts += 1
        self.adoptions += adopted
        return adopted

    def evict(self, need: int) -> int:
        """Free up to ``need`` blocks by dropping tree-only (refcount 1)
        leaves, the deepest first (the first root's on a tie). Returns
        how many were freed; a subtree a lane maps is never touched."""
        freed = 0
        while freed < need:
            victim = None
            for root in self._roots.values():
                stack = [(c, 1) for c in root.children.values()]
                best = None
                while stack:
                    n, d = stack.pop()
                    if n.children:
                        stack.extend((c, d + 1)
                                     for c in n.children.values())
                    elif self.pool.refcount(n.block) == 1:
                        if best is None or d > best[1]:
                            best = (n, d)
                if best is not None and (victim is None
                                         or best[1] > victim[1]):
                    victim = best
            if victim is None:
                break
            node = victim[0]
            del node.parent.children[node.chunk]
            self.pool.decref(node.block)
            freed += 1
            self.evicted_blocks += 1
        for key in [k for k, r in self._roots.items() if not r.children]:
            del self._roots[key]
        return freed

    def tree_blocks(self) -> set:
        """Every block a node holds (the tree's own refs)."""
        out = set()
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                n = stack.pop()
                out.add(n.block)
                stack.extend(n.children.values())
        return out

    @property
    def n_nodes(self) -> int:
        return len(self.tree_blocks())
