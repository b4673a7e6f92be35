"""Decoding layers (reference python/paddle/fluid/layers/nn.py
beam_search, beam_search_decode, edit_distance; the port's subset of
paddle_tpu/layers/rnn.py). The recurrent cells and the CTC layers of
that file are not ported yet."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["beam_search", "beam_search_decode", "edit_distance"]

# the companion length var of a padded sequence (the JAX package's
# layers/sequence.py SEQ_LEN_SUFFIX)
SEQ_LEN_SUFFIX = "@SEQ_LEN"


def _seq_len_of(x):
    """The int32 [B] length var that goes with padded `x`, declared as a
    data var (fed) the first time it is asked for."""
    name = x.name + SEQ_LEN_SUFFIX
    if x.block.has_var(name):
        return x.block.var(name)
    return x.block.create_var(name=name, shape=(-1,), dtype="int32",
                              is_data=True, stop_gradient=True)


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One beam-search step (the ``beam_search`` op): (selected_ids,
    selected_scores), and parent_idx with `return_parent_idx`."""
    helper = LayerHelper("beam_search", input=ids, name=name)
    sel_ids = helper.create_variable_for_type_inference("int64", True)
    sel_scores = helper.create_variable_for_type_inference(
        scores.dtype, True)
    parent = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(
        "beam_search",
        {"pre_ids": pre_ids, "pre_scores": pre_scores, "ids": ids,
         "scores": scores},
        {"selected_ids": sel_ids, "selected_scores": sel_scores,
         "parent_idx": parent},
        {"beam_size": beam_size, "end_id": end_id, "level": level,
         "is_accumulated": is_accumulated})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, beam_size, end_id, name=None,
                       parents=None):
    """Backtrack stacked beam selections (the ``beam_search_decode``
    op): (sentence ids [T, rows], sentence scores [rows]). Without
    `parents` each beam is its own ancestor."""
    helper = LayerHelper("beam_search_decode", input=ids, name=name)
    out_ids = helper.create_variable_for_type_inference("int64", True)
    out_scores = helper.create_variable_for_type_inference(
        scores.dtype, True)
    inputs = {"Ids": ids, "Scores": scores}
    if parents is not None:
        inputs["Parents"] = parents
    helper.append_op("beam_search_decode", inputs,
                     {"SentenceIds": out_ids,
                      "SentenceScores": out_scores},
                     {"beam_size": beam_size, "end_id": end_id})
    return out_ids, out_scores


def edit_distance(input, label, normalized=True, ignored_tokens=None):
    """Levenshtein distance of each padded row of `input` to `label`'s,
    over the lengths fed as ``<name>@SEQ_LEN``: (distances [B, 1],
    sequence count [1])."""
    helper = LayerHelper("edit_distance", input=input)
    out = helper.create_variable_for_type_inference("float32", True)
    seq_num = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("edit_distance",
                     {"Hyps": input, "Refs": label,
                      "HypsLen": _seq_len_of(input),
                      "RefsLen": _seq_len_of(label)},
                     {"Out": out, "SequenceNum": seq_num},
                     {"normalized": normalized})
    return out, seq_num
