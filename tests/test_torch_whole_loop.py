"""The whole-loop decode programs of the port
(``decode_engine.build_greedy_decode_program`` and
``build_beam_decode_program``) against the JAX package's, on the CPU.

Model: d 32, 2 heads, 2+2 layers, d_inner 64, vocab 50, prompts of 12,
16 tokens out, start 2, end 1. Weights from seeded numpy
(``torch_paged_setup.weights``, seed 2) with the word embeddings scaled
by 8 and 0.3 added to end_id's logit column, so that the greedy rows
vary and stop after 3 to 15 tokens (checked before it is relied on).

Tolerances: greedy tokens equal JAX's and the port's incremental
decode's exactly; beam SentenceIds equal JAX's exactly and
SentenceScores within 1e-5 (sums of up to 15 fp32 log-probs, the
libraries summing in their own orders); against the port's
PagedBeamDecoder (tests/torch_radix_setup.py's weights) the hypothesis
sets equal and the scores within 1e-4, the JAX package's own pin
(tests/test_radix_reuse.py:223); on a memorised toy sequence the best
beam's score equals its summed log-softmax within 1e-3
(tests/test_contrib_suite.py's contract).
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.models import decode_engine as PD
from paddle_tpu_torch.models import transformer as PT

from torch_paged_setup import jax_scope, weights

MODEL = dict(seq_len=12, max_out_len=16, d_model=32, n_heads=2,
             n_layers=2, d_inner=64, vocab=50, start_id=2, end_id=1)
EMB_SCALE, EOS_BIAS, WEIGHT_SEED = 8.0, 0.3, 2
SCORE_TOL = 1e-5
PAGED_SCORE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(startup):
    w = weights(startup, WEIGHT_SEED)
    for emb in ("src_word_emb", "tgt_word_emb"):
        w[emb] = w[emb] * EMB_SCALE
    w["logits.w"][:, MODEL["end_id"]] += EOS_BIAS
    return w


@pytest.fixture(scope="module")
def world():
    with p_unique_name.guard():
        greedy = PD.build_greedy_decode_program(**MODEL)
    params = _weights(greedy[1])
    scope = pf.Scope()
    pf.load_numpy_params(scope, params, pf.CPUPlace())
    src = np.random.RandomState(5).randint(
        3, MODEL["vocab"], (6, MODEL["seq_len"])).astype(np.int64)
    return dict(greedy=greedy, params=params, scope=scope, src=src,
                exe=pf.Executor(pf.CPUPlace()),
                jexe=jf.Executor(jf.CPUPlace()),
                jscope=jax_scope(params))


def test_greedy_matches_jax_and_incremental(world):
    main, _, _, out = world["greedy"]
    toks, steps = world["exe"].run(
        main, feed={"src_ids": world["src"]},
        fetch_list=[out, PD.DECODE_STEPS_VAR], scope=world["scope"])
    lengths = PS.count_generated_tokens(toks, MODEL["end_id"])
    # the fixed weights give rows that stop early and rows that run on
    assert lengths.min() <= 5 and lengths.max() == 15, lengths
    assert all(len(set(r)) >= 3 for r in toks)
    with j_unique_name.guard():
        jmain, _, _, jout = JT.build_greedy_decode_program(**MODEL)
    jtoks, jsteps = world["jexe"].run(
        jmain, feed={"src_ids": world["src"]},
        fetch_list=[jout, "@decode_steps"], scope=world["jscope"])
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    assert int(steps[0]) == int(np.asarray(jsteps)[0])
    with p_unique_name.guard():
        imain, _, _, iout = PD.build_incremental_decode_program(**MODEL)
    itoks = world["exe"].run(imain, feed={"src_ids": world["src"]},
                             fetch_list=[iout], scope=world["scope"])[0]
    np.testing.assert_array_equal(toks, itoks)


def test_programs_match_the_jax_programs():
    """The same ops, in order, in both blocks of each program, and the
    same parameters."""
    kw = dict(MODEL, beam_size=3, batch_size=2)
    with j_unique_name.guard():
        jg = JT.build_greedy_decode_program(**MODEL)[0]
        jb = JT.build_beam_decode_program(**kw)[0]
    with p_unique_name.guard():
        pg = PT.build_greedy_decode_program(**MODEL)[0]
        pb = PT.build_beam_decode_program(**kw)[0]
    for j, p in ((jg, pg), (jb, pb)):
        assert len(p.blocks) == len(j.blocks) == 2
        for jblk, pblk in zip(j.blocks, p.blocks):
            assert [o.type for o in pblk.ops] == [o.type for o in jblk.ops]
        assert sorted(x.name for x in p.all_parameters()) == \
            sorted(x.name for x in j.all_parameters())


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_matches_jax(world, beam):
    kw = dict(MODEL, beam_size=beam, batch_size=2)
    with j_unique_name.guard():
        jmain, _, _, (jids, jscores) = JT.build_beam_decode_program(**kw)
    with p_unique_name.guard():
        pmain, _, _, (pids, pscores) = PD.build_beam_decode_program(**kw)
    src = world["src"][:2]
    ids, scores = world["exe"].run(pmain, feed={"src_ids": src},
                                   fetch_list=[pids, pscores],
                                   scope=world["scope"])
    want_ids, want_scores = world["jexe"].run(
        jmain, feed={"src_ids": src}, fetch_list=[jids, jscores],
        scope=world["jscope"])
    assert ids.dtype == np.int64
    assert ids.shape == (MODEL["max_out_len"], 2 * beam)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    np.testing.assert_allclose(scores, np.asarray(want_scores), rtol=0,
                               atol=SCORE_TOL)
    if beam > 1:
        # a real search: the hypotheses of a source differ
        rows = ids.T.reshape(2, beam, -1)
        assert all(len({tuple(h) for h in r}) == beam for r in rows)


def test_beam_matches_paged_beam_decoder():
    """The whole loop against the port's PagedBeamDecoder at beam 3 on
    tests/torch_radix_setup.py's weights and prompts: the same
    hypotheses, scores within 1e-4."""
    from torch_radix_setup import MODEL as RM
    from torch_radix_setup import PortModel, port_bundle, prompts

    m = PortModel()
    with p_unique_name.guard():
        main, _, _, (ids_v, scores_v) = PD.build_beam_decode_program(
            beam_size=3, batch_size=1, **RM)
    dec = PS.PagedBeamDecoder(port_bundle(m), 3, executor=m.exe,
                              scope=m.scope)
    srcs = prompts(5, 12)
    for r in (1, 3):
        ids, scores = m.exe.run(main, feed={"src_ids": srcs[r][None]},
                                fetch_list=[ids_v, scores_v],
                                scope=m.scope)
        whole = PS.apply_eos_sentinel(ids.T, RM["end_id"])
        hyps = dec.decode(srcs[r], return_all=True)
        assert {tuple(t) for t, _ in hyps} == {tuple(h) for h in whole}
        for g, w in zip(sorted(s for _, s in hyps), sorted(scores)):
            assert abs(g - float(w)) <= PAGED_SCORE_TOL, (g, w)


def test_beam_on_memorised_sequence_agrees_with_greedy():
    """tests/test_contrib_suite.py's contract on the port: a toy
    Transformer trained to copy [4, 7, 9, 1]; the best of 3 beams is the
    greedy continuation up to EOS, the other beams differ from it, and
    the best score is the sum of its tokens' log-softmax."""
    V, D, L, S = 12, 16, 1, 4
    with p_unique_name.guard():
        main, startup, loss = PT.build_program(
            seq_len=S, d_model=D, n_heads=2, n_layers=L, d_inner=32,
            vocab=V, with_optimizer=False, dropout_rate=0.0)
        with pf.program_guard(main, startup):
            pf.optimizer.Adam(learning_rate=0.02).minimize(loss)
    startup.random_seed = 7
    exe, scope = pf.Executor(pf.CPUPlace()), pf.Scope()
    exe.run(startup, scope=scope)
    src = np.array([[4, 7, 9, 1]], np.int64)
    feed = {"src_ids": src, "tgt_ids": np.array([[2, 4, 7, 9]], np.int64),
            "label": src}
    for _ in range(60):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    kw = dict(seq_len=S, max_out_len=S + 2, d_model=D, n_heads=2,
              n_layers=L, d_inner=32, vocab=V, start_id=2, end_id=1)
    with p_unique_name.guard():
        gm, _, _, gbuf = PT.build_greedy_decode_program(**kw)
        bm, _, _, (bids, bscores) = PT.build_beam_decode_program(
            beam_size=3, **kw)
    greedy, = exe.run(gm, feed={"src_ids": src}, fetch_list=[gbuf],
                      scope=scope)
    beam_ids, beam_scores = exe.run(bm, feed={"src_ids": src},
                                    fetch_list=[bids, bscores],
                                    scope=scope)
    cont = greedy[0, 1:]
    eos_at = int(np.argmax(cont == 1)) + 1 if (cont == 1).any() \
        else len(cont)
    np.testing.assert_array_equal(beam_ids[1:1 + eos_at, 0], cont[:eos_at])
    np.testing.assert_array_equal(beam_ids[1:5, 0], src[0])
    assert any(not np.array_equal(beam_ids[:, j], beam_ids[:, 0])
               for j in range(1, beam_ids.shape[1]))
    with p_unique_name.guard():
        lp, lstart = pf.Program(), pf.Program()
        with pf.program_guard(lp, lstart):
            s_in = pf.layers.data("src_ids", shape=[S], dtype="int64")
            t_in = pf.layers.data("tgt_ids", shape=[S + 2], dtype="int64")
            lbl = pf.layers.data("label", shape=[S + 2], dtype="int64")
            _, lg = PT.transformer(
                s_in, t_in, lbl, src_vocab=V, tgt_vocab=V, max_len=S + 2,
                d_model=D, n_heads=2, n_layers=L, d_inner=32,
                dropout_rate=0.0, is_test=True, label_smooth_eps=0.0)
    tgt = beam_ids[:, 0][None, :].astype(np.int64)
    lg_v, = exe.run(lp, feed={"src_ids": src, "tgt_ids": tgt,
                              "label": np.zeros_like(tgt)},
                    fetch_list=[lg], scope=scope)
    logp = lg_v - np.log(np.exp(lg_v).sum(-1, keepdims=True))
    expected = 0.0
    for t in range(beam_ids.shape[0] - 1):
        tok = int(beam_ids[t + 1, 0])
        expected += logp[0, t, tok]
        if tok == 1:
            break
    assert abs(float(beam_scores[0]) - expected) < 1e-3, \
        (float(beam_scores[0]), expected)


def test_sharding_is_refused_naming_a10():
    with pytest.raises(NotImplementedError, match="A10"):
        PD.build_greedy_decode_program(sharding=object(), **MODEL)
