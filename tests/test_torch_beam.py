"""The port's PagedBeamDecoder on the CPU against the JAX package's on the
same weights and prompts (tests/torch_radix_setup.py): hypotheses equal
and scores within 1e-4 (the JAX package's own pin,
tests/test_radix_reuse.py:223), at beam 1 and 3, over prompts whose
beams branch inside a block (COW copies) and across block boundaries;
the block pool free after every decode. Also the bundle's probe program
against the JAX package's, and the decoder's refusals.
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.models import decode_engine as PD

from torch_radix_setup import (MODEL, N_BLOCKS, PortModel, jax_bundle,
                               jax_executor, jax_scope, paged_cache,
                               port_bundle, prompts)

SCORE_TOL = 1e-4
ROWS = [1, 3, 0, 9]   # stop after 16 and 12 tokens, run to the end, 15


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    m = PortModel()
    srcs = prompts(5, 12)
    return dict(m=m, srcs=srcs, bundle=port_bundle(m), jb=jax_bundle(),
                jexe=jax_executor(), jscope=jax_scope(m.params),
                want=m.decode(srcs))


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_matches_jax(world, beam):
    from paddle_tpu.inference import serving as JS

    pdec = PS.PagedBeamDecoder(world["bundle"], beam,
                               executor=world["m"].exe, scope=world["m"].scope)
    jdec = JS.PagedBeamDecoder(world["jb"], beam, executor=world["jexe"],
                               scope=world["jscope"])
    crossed = False
    for r in ROWS:
        got = pdec.decode(world["srcs"][r], return_all=True)
        assert pdec._pool.free_count == N_BLOCKS
        want = jdec.decode(world["srcs"][r], return_all=True)
        assert len(got) == len(want) == beam
        for (gt, gs), (wt, ws) in zip(got, want):
            np.testing.assert_array_equal(gt, np.asarray(wt, np.int64))
            assert abs(gs - float(ws)) <= SCORE_TOL
        assert [s for _, s in got] == sorted((s for _, s in got),
                                             reverse=True)
        lengths = PS.count_generated_tokens(np.stack([t for t, _ in got]),
                                            MODEL["end_id"])
        crossed |= bool((lengths > 8).any())
        if beam == 1:
            # greedy: the whole-loop decode, with no copy
            np.testing.assert_array_equal(got[0][0], world["want"][r])
    assert crossed, "no hypothesis crossed a block boundary"
    assert pdec.cow_blocks == jdec.cow_blocks
    assert pdec.shared_block_peak == jdec.shared_block_peak
    if beam == 1:
        assert pdec.cow_blocks == 0
    else:
        assert pdec.cow_blocks >= 1 and pdec.shared_block_peak >= 1
    # the best hypothesis alone
    toks, score = pdec.decode(world["srcs"][ROWS[0]])
    assert toks.shape == (MODEL["max_out_len"],) and isinstance(score,
                                                                float)


def test_probe_tick_matches_jax(world):
    """One probe tick after a one-lane admission (n_steps 0) under
    teacher forcing over the whole buffer: the lane's softmax row within
    1e-5 of the JAX package's, its token-buffer row untouched and its
    finished flag not latched, one tick counted."""

    b, jb = world["bundle"], world["jb"]
    src = world["srcs"][3]
    maxT = MODEL["max_out_len"]
    rows = b.n_slots + 1
    feed = {"src_ids": src[None], "slots": np.array([0], np.int64),
            "prompt_slots": np.array([0], np.int64),
            "n_steps": np.array([0], np.int64),
            "min_active": np.array([0], np.int64)}
    tab = np.zeros((rows, b.cache.pages(maxT)), np.int32)
    tab[0, 0] = 2
    pref = np.full((rows,), b.cache.n_prompt_entries, np.int32)
    pref[0] = 0
    until = np.full((rows,), maxT, np.int64)
    st = b.state

    scope = pf.Scope()
    for name, arr in world["m"].params.items():
        scope._set(name, torch.from_numpy(arr.copy()))
    b.init_slot_state(scope, "cpu")
    exe = world["m"].exe
    scope._set(st["block_tab"], torch.from_numpy(tab.copy()))
    scope._set(st["prompt_ref"], torch.from_numpy(pref.copy()))
    exe.run(b.serves[("miss", 1)], feed=feed, scope=scope)
    scope._set(st["prefill_until"], torch.from_numpy(until.copy()))
    buf0 = scope._get(st["tok_buf"]).numpy().copy()
    probs = exe.run(b.probe, fetch_list=[st["probe_probs"]], scope=scope)[0]

    jscope = jax_scope(world["m"].params)
    jb.init_slot_state(jscope)
    jscope._set(st["block_tab"], tab.copy())
    jscope._set(st["prompt_ref"], pref.copy())
    jexe = world["jexe"]
    jexe.run(jb.serves[("miss", 1)], feed=feed, scope=jscope)
    jscope._set(st["prefill_until"], until.copy())
    jprobs = jexe.run(jb.probe, fetch_list=[st["probe_probs"]],
                      scope=jscope)[0]

    assert probs.shape == (rows, MODEL["vocab"])
    np.testing.assert_allclose(probs[0], np.asarray(jprobs)[0], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    # the forced lane's row is untouched (idle lanes emit end_id)
    np.testing.assert_array_equal(scope._get(st["tok_buf"]).numpy()[0],
                                  buf0[0])
    assert int(scope._get(st["finished"])[0]) == 0
    assert int(scope._get(st["step"])[0]) == 1
    assert int(scope._get(st["tel_ticks"])[0]) == 1


def test_beam_decoder_refusals(world):
    m = world["m"]
    with pytest.raises(ValueError, match="paged bundle"):
        PS.PagedBeamDecoder(m.bundle(2), 1, executor=m.exe, scope=m.scope)
    with pytest.raises(ValueError, match="must fit"):
        PS.PagedBeamDecoder(world["bundle"], world["bundle"].n_slots + 1,
                            executor=m.exe, scope=m.scope)
    dec = PS.PagedBeamDecoder(world["bundle"], 2, executor=m.exe,
                              scope=m.scope)
    with pytest.raises(ValueError, match="seq_len"):
        dec.decode(world["srcs"][0][:5])
    # beams that outgrow a 4-block pool fail with the named, retryable
    # error instead of writing through unallocated table cells
    tiny = m.bundle(2, paged_cache(4, 1), state_prefix="@bt/")
    dec = PS.PagedBeamDecoder(tiny, 2, executor=m.exe, scope=m.scope)
    with pytest.raises(PD.BlockPoolExhausted) as ei:
        dec.decode(world["srcs"][0])
    assert ei.value.retryable
