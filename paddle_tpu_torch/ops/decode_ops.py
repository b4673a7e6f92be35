"""Decoding ops: beam_search, beam_search_decode, edit_distance and
ctc_align (the port's counterparts of ``paddle_tpu/ops/decode_ops.py``;
reference operators/beam_search_op.cc, beam_search_decode_op.cc,
edit_distance_op.cc, ctc_align_op.cc, math/beam_search.cc).

As in the JAX package, beams are a dense [batch, beam] axis at static
shapes, parents are explicit index tensors and the backtrack is a loop
over steps on the device: no LoD, nothing read back to the host. Ids
and parent indices come out int64 (the JAX package's parent_idx is
int32): the port's index type.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("beam_search", differentiable=False,
             stop_gradient_slots=("pre_ids", "ids"))
def beam_search(ctx):
    """One beam-search step over dense [batch*beam, K] candidates.

    inputs: pre_ids [B*beam, 1] (the last selected ids), pre_scores
    [B*beam, 1] (cumulative log-probs), ids [B*beam, K] (each beam's
    candidate tokens), scores [B*beam, K]. attrs: beam_size, end_id,
    is_accumulated (True: `scores` are already each candidate's total;
    False: they are per-step probabilities, added to pre_scores as
    logs). outputs: selected_ids and selected_scores [B*beam, 1],
    parent_idx [B*beam], the absolute row each selection extends.

    A finished beam (pre_id == end_id) is frozen: its only candidate is
    end_id at its old score, the other K-1 the most negative float. Each
    source picks its `beam` best of its beam*K candidates, ties in
    candidate order (``lax.top_k``'s order: a stable descending sort,
    since ``torch.topk`` promises none, and frozen rows always tie)."""
    pre_ids = ctx.input("pre_ids")
    pre_scores = ctx.input("pre_scores")
    ids = ctx.input("ids")
    scores = ctx.input("scores")
    beam = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id", 0))
    rows, k = ids.shape[0], ids.shape[1]
    b = rows // beam
    finished = (pre_ids.reshape(rows) == end_id)[:, None]
    if ctx.attr("is_accumulated", True):
        total = scores
    else:
        total = pre_scores.reshape(rows, 1) + torch.log(
            torch.clamp(scores, min=1e-30))
    neg = torch.finfo(total.dtype).min
    frozen_scores = torch.cat(
        [pre_scores.reshape(rows, 1).to(total.dtype),
         total.new_full((rows, k - 1), neg)], dim=1)
    total = torch.where(finished, frozen_scores, total)
    cand_ids = torch.where(finished, torch.full_like(ids, end_id), ids)
    vals, pos = torch.sort(total.reshape(b, beam * k), dim=1,
                           descending=True, stable=True)
    top_scores, top_pos = vals[:, :beam], pos[:, :beam]
    sel_ids = torch.gather(cand_ids.reshape(b, beam * k), 1, top_pos)
    parent = top_pos // k + torch.arange(
        b, dtype=top_pos.dtype, device=top_pos.device)[:, None] * beam
    return {"selected_ids": sel_ids.reshape(rows, 1),
            "selected_scores": top_scores.reshape(rows, 1),
            "parent_idx": parent.reshape(rows)}


@register_op("beam_search_decode", differentiable=False,
             stop_gradient_slots=("Ids", "Parents"))
def beam_search_decode(ctx):
    """Backtrack stacked per-step selections into whole sequences.

    inputs: Ids [T, B*beam, 1], Parents of the same shape (optional:
    without it each beam is its own ancestor), Scores (optional:
    per-step cumulative scores [T, B*beam, ...], or the final ones
    [B*beam]). outputs: SentenceIds [T, B*beam] int64 and
    SentenceScores [B*beam] (the last step's scores; zeros without
    Scores). The walk runs from the last step back to the first, each
    step reading its token and parent at the row the later step names
    (a ``lax.scan`` in reverse in the JAX package)."""
    ids = ctx.input("Ids")
    parents = ctx.input("Parents")
    scores = ctx.input("Scores")
    t = ids.shape[0]
    ids2 = ids.reshape(t, -1)
    rows = ids2.shape[1]
    if parents is None:
        par2 = torch.arange(rows, device=ids.device).expand(t, rows)
    else:
        par2 = parents.reshape(t, -1).to(torch.int64)
    cur = torch.arange(rows, device=ids.device)
    toks = [None] * t
    for s in range(t - 1, -1, -1):
        toks[s] = ids2[s][cur]
        cur = par2[s][cur]
    sentence = torch.stack(toks).to(torch.int64)
    if scores is None:
        final = torch.zeros((rows,), dtype=torch.float32, device=ids.device)
    elif scores.shape[0] == t and scores.numel() == t * rows:
        final = scores.reshape(t, -1)[-1]
    else:
        final = scores.reshape(-1)
    return {"SentenceIds": sentence, "SentenceScores": final}


@register_op("edit_distance", differentiable=False,
             stop_gradient_slots=("Hyps", "Refs", "HypsLen", "RefsLen"))
def edit_distance(ctx):
    """Batched Levenshtein distance over padded int sequences.

    inputs: Hyps [B, Th], Refs [B, Tr], HypsLen / RefsLen [B] (optional:
    the full widths). attr: normalized (divide by max(ref length, 1)).
    outputs: Out [B, 1] float32, SequenceNum [1] int64. One DP row per
    ref position for every batch row at once; a row whose ref has ended
    keeps its row, and the distance is read at the hyp's length (the JAX
    package's nested scans, as loops over the same cells)."""
    hyps, refs = ctx.input("Hyps"), ctx.input("Refs")
    b, th, tr = hyps.shape[0], hyps.shape[1], refs.shape[1]
    dev = hyps.device
    hlen, rlen = ctx.input("HypsLen"), ctx.input("RefsLen")
    hlen = torch.full((b,), th, device=dev) if hlen is None \
        else hlen.reshape(b).to(torch.int64)
    rlen = torch.full((b,), tr, device=dev) if rlen is None \
        else rlen.reshape(b).to(torch.int64)
    row = torch.arange(th + 1, dtype=torch.float32,
                       device=dev).expand(b, th + 1)
    for i in range(tr):
        sub = (hyps != refs[:, i:i + 1]).to(torch.float32)
        cell = torch.full((b,), float(i + 1), device=dev)
        cells = [cell]
        for j in range(1, th + 1):
            cell = torch.minimum(torch.minimum(row[:, j] + 1.0, cell + 1.0),
                                 row[:, j - 1] + sub[:, j - 1])
            cells.append(cell)
        new = torch.stack(cells, dim=1)
        row = torch.where((i < rlen)[:, None], new, row)
    dist = torch.gather(row, 1, hlen[:, None])[:, 0]
    if ctx.attr("normalized", False):
        dist = dist / torch.clamp(rlen.to(torch.float32), min=1.0)
    return {"Out": dist.reshape(b, 1),
            "SequenceNum": torch.full((1,), b, dtype=torch.int64,
                                      device=dev)}


@register_op("ctc_align", differentiable=False,
             stop_gradient_slots=("Input", "InputLen"))
def ctc_align(ctx):
    """CTC post-alignment: merge repeats, drop blanks (reference
    ctc_align_op.cc). inputs: Input [B, T] (the argmax path), InputLen
    or SeqLen [B] (optional). attr: blank. outputs: Output [B, T], the
    kept tokens left-aligned and `blank`-padded, and OutputLen [B]
    int32. A kept token goes to the column the count of kept tokens
    before it names; the others to a spare column past the end."""
    x = ctx.input("Input")
    b, t = x.shape[0], x.shape[1]
    blank = int(ctx.attr("blank", 0))
    xlen = ctx.input("InputLen")
    if xlen is None:
        xlen = ctx.input("SeqLen")
    xlen = torch.full((b,), t, device=x.device) if xlen is None \
        else xlen.reshape(b).to(torch.int64)
    valid = torch.arange(t, device=x.device)[None, :] < xlen[:, None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=x.dtype,
                                 device=x.device), x[:, :-1]], dim=1)
    keep = valid & (x != blank) & (x != prev)
    tgt = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    tgt = torch.where(keep, tgt, t)
    out = torch.full((b, t + 1), blank, dtype=x.dtype, device=x.device)
    out = out.scatter(1, tgt, torch.where(keep, x, blank))
    return {"Output": out[:, :t],
            "OutputLen": keep.to(torch.int32).sum(dim=1, dtype=torch.int32)}
