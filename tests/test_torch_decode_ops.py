"""The port's decode ops (beam_search, beam_search_decode, edit_distance,
ctc_align) and scatter against the JAX package's, one op at a time
through ``tests/torch_op_test.py``'s ``op_case``, on the CPU.

Ids and lengths are compared exactly by value (the port keeps ids in
int64; the JAX package, without x64, in int32), scores and distances
within 1e-6 with the same float dtype. The edges: frozen rows, all rows
frozen, ties among candidates, is_accumulated both ways;
beam_search_decode without parents and with each form of scores;
edit_distance with lengths shorter than the pad, normalized, empty
refs; ctc_align with blank runs and repeats; scatter with negative,
out-of-range and (adding) duplicate ids.
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

from torch_op_test import op_case

TOL = 1e-6


def _check(case):
    got = {s: t.numpy() for s, t in case.port_outputs().items()}
    want = case.reference_outputs()
    assert set(got) == set(want), (sorted(got), sorted(want))
    for s in want:
        g, w = got[s], want[s]
        assert g.shape == w.shape, (s, g.shape, w.shape)
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype, (s, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=s)
        else:
            assert g.dtype.kind == w.dtype.kind, (s, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=s)
    return got


# --- beam_search -------------------------------------------------------------
B, BEAM, K, END = 2, 3, 4, 1
ROWS = B * BEAM


def _beam_inputs(seed, frozen=(), ties=False, probs=False):
    r = np.random.RandomState(seed)
    pre_ids = r.randint(2, 20, (ROWS, 1)).astype(np.int64)
    pre_ids[list(frozen), 0] = END
    pre_scores = -r.uniform(0, 5, (ROWS, 1)).astype(np.float32)
    ids = r.randint(0, 20, (ROWS, K)).astype(np.int64)
    if probs:
        scores = r.uniform(0.01, 1.0, (ROWS, K)).astype(np.float32)
    elif ties:
        # a coarse grid: equal totals within and across beams
        scores = -np.round(r.uniform(0, 2, (ROWS, K)) * 2) / 2
        scores = scores.astype(np.float32)
    else:
        scores = pre_scores - r.uniform(0, 3, (ROWS, K)).astype(np.float32)
    return {"pre_ids": pre_ids, "pre_scores": pre_scores, "ids": ids,
            "scores": scores}


BEAM_CASES = {
    "plain": (_beam_inputs(0), True),
    "frozen_rows": (_beam_inputs(1, frozen=(0, 4)), True),
    "all_frozen": (_beam_inputs(2, frozen=range(ROWS)), True),
    "ties": (_beam_inputs(3, ties=True), True),
    "ties_and_frozen": (_beam_inputs(4, frozen=(1,), ties=True), True),
    "not_accumulated": (_beam_inputs(5, probs=True), False),
    "not_accumulated_frozen": (_beam_inputs(6, frozen=(2, 3), probs=True),
                               False),
}


@pytest.mark.parametrize("name", sorted(BEAM_CASES))
def test_beam_search(name):
    inputs, acc = BEAM_CASES[name]
    got = _check(op_case(
        "beam_search", inputs,
        {"beam_size": BEAM, "end_id": END, "is_accumulated": acc},
        outputs=("selected_ids", "selected_scores", "parent_idx")))
    assert got["parent_idx"].dtype == np.int64
    par = got["parent_idx"].reshape(B, BEAM)
    # absolute rows, each inside its own source's block
    assert ((par // BEAM) == np.arange(B)[:, None]).all()
    frozen = inputs["pre_ids"][:, 0] == END
    for row in np.nonzero(frozen)[0]:
        # a frozen beam's only candidate: end_id at its old score
        hit = got["parent_idx"] == row
        assert (got["selected_ids"][hit] == END).all()


# --- beam_search_decode ------------------------------------------------------
T = 5


def _decode_inputs(seed, scores="steps", parents=True):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 30, (T, ROWS, 1)).astype(np.int64)
    out = {"Ids": ids}
    if parents:
        blocks = np.arange(ROWS) // BEAM * BEAM
        out["Parents"] = (blocks[None, :, None]
                          + r.randint(0, BEAM, (T, ROWS, 1))).astype(
                              np.int64)
    if scores == "steps":
        out["Scores"] = -np.cumsum(r.uniform(0, 1, (T, ROWS, 1)),
                                   axis=0).astype(np.float32)
    elif scores == "final":
        out["Scores"] = -r.uniform(0, 5, (ROWS,)).astype(np.float32)
    return out


DECODE_CASES = {
    "parents_step_scores": _decode_inputs(0),
    "parents_final_scores": _decode_inputs(1, scores="final"),
    "parents_no_scores": _decode_inputs(2, scores=None),
    "no_parents_step_scores": _decode_inputs(3, parents=False),
    "no_parents_final_scores": _decode_inputs(4, scores="final",
                                              parents=False),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_beam_search_decode(name):
    inputs = DECODE_CASES[name]
    got = _check(op_case("beam_search_decode", inputs,
                         {"beam_size": BEAM, "end_id": END},
                         outputs=("SentenceIds", "SentenceScores")))
    assert got["SentenceIds"].dtype == np.int64
    assert got["SentenceIds"].shape == (T, ROWS)
    if "Parents" not in inputs:
        np.testing.assert_array_equal(got["SentenceIds"],
                                      inputs["Ids"][:, :, 0])


# --- edit_distance -----------------------------------------------------------
def _ed_inputs(seed, hlen=None, rlen=None, th=6, tr=5, b=4):
    r = np.random.RandomState(seed)
    out = {"Hyps": r.randint(0, 4, (b, th)).astype(np.int64),
           "Refs": r.randint(0, 4, (b, tr)).astype(np.int64)}
    if hlen is not None:
        out["HypsLen"] = np.asarray(hlen, np.int64)
    if rlen is not None:
        out["RefsLen"] = np.asarray(rlen, np.int64)
    return out


ED_CASES = {
    "full_width": (_ed_inputs(0), False),
    "full_width_normalized": (_ed_inputs(1), True),
    "short_lengths": (_ed_inputs(2, hlen=[6, 3, 1, 0], rlen=[5, 2, 4, 1]),
                      False),
    "short_lengths_normalized": (
        _ed_inputs(3, hlen=[2, 6, 4, 5], rlen=[3, 5, 1, 2]), True),
    "empty_refs": (_ed_inputs(4, hlen=[6, 2, 0, 4], rlen=[0, 0, 0, 3]),
                   False),
    "empty_refs_normalized": (
        _ed_inputs(5, hlen=[6, 2, 0, 4], rlen=[0, 0, 0, 3]), True),
}


@pytest.mark.parametrize("name", sorted(ED_CASES))
def test_edit_distance(name):
    inputs, normalized = ED_CASES[name]
    got = _check(op_case("edit_distance", inputs,
                         {"normalized": normalized},
                         outputs=("Out", "SequenceNum")))
    if name == "empty_refs":
        # against an empty ref the distance is the hyp's length
        np.testing.assert_array_equal(got["Out"][:3, 0], [6, 2, 0])


# --- ctc_align ---------------------------------------------------------------
CTC_X = np.array([[0, 0, 3, 3, 0, 3, 5, 5, 0, 0],
                  [2, 2, 2, 0, 0, 0, 2, 0, 1, 1],
                  [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                  [4, 1, 4, 1, 4, 0, 0, 4, 4, 4]], np.int64)

CTC_CASES = {
    "blank0_full": ({"Input": CTC_X}, 0),
    "blank0_input_len": ({"Input": CTC_X,
                          "InputLen": np.array([7, 10, 3, 5], np.int64)},
                         0),
    "blank4_seq_len": ({"Input": CTC_X,
                        "SeqLen": np.array([10, 4, 10, 9], np.int64)}, 4),
}


@pytest.mark.parametrize("name", sorted(CTC_CASES))
def test_ctc_align(name):
    inputs, blank = CTC_CASES[name]
    got = _check(op_case("ctc_align", inputs, {"blank": blank},
                         outputs=("Output", "OutputLen")))
    if name == "blank0_full":
        np.testing.assert_array_equal(got["Output"][0, :3], [3, 3, 5])
        np.testing.assert_array_equal(got["OutputLen"], [3, 3, 0, 6])


# --- scatter -----------------------------------------------------------------
def _scatter_inputs(ids, seed=0):
    r = np.random.RandomState(seed)
    return {"X": r.randn(5, 3).astype(np.float32),
            "Ids": np.asarray(ids, np.int64),
            "Updates": r.randn(len(ids), 3).astype(np.float32)}


SCATTER_CASES = {
    "set": ([4, 0, 2], True),
    "set_negative": ([-1, -5, 1], True),
    "set_out_of_range": ([7, 2, -6, 5], True),
    "add_duplicates": ([1, 3, 1, 1], False),
    "add_negative_duplicates": ([-2, 3, -2, 0], False),
    "add_out_of_range": ([9, 0, -7, 0, 5], False),
}


@pytest.mark.parametrize("name", sorted(SCATTER_CASES))
def test_scatter(name):
    ids, overwrite = SCATTER_CASES[name]
    case = op_case("scatter", _scatter_inputs(ids),
                   {"overwrite": overwrite})
    case.check_output(rtol=0, atol=TOL)
    if not overwrite:
        case.check_grad(["X", "Updates"])


def test_scatter_broadcasts_one_row():
    """The beam program's form: one id, updates [1, rows, 1]."""
    case = op_case("scatter", {
        "X": np.zeros((4, 6, 1), np.int64),
        "Ids": np.array([2], np.int64),
        "Updates": np.arange(6, dtype=np.int64).reshape(1, 6, 1)},
        {"overwrite": True})
    got = _check(case)
    np.testing.assert_array_equal(got["Out"][2, :, 0], np.arange(6))


def test_log():
    """The beam program's log of its top-k probabilities."""
    x = np.random.RandomState(0).uniform(0.1, 3.0, (4, 5)).astype(
        np.float32)
    case = op_case("log", {"X": x})
    case.check_output(rtol=1e-6, atol=0)
    case.check_grad(["X"])
