"""The port's adaptive speculation on the CPU: the ``SpecController``
policy, the k ladder's serves, the model-free n-gram lane and draft
distillation, held against the JAX package
(tests/test_adaptive_spec.py's cases, at its size):

* the controller's policy cases on the port's class;
* every rung of the ladder, and rung switches mid-flight, give the JAX
  package's whole-loop greedy decode; the automatic controller holds a
  positive rung on the trained pair, parks at 0 on a poisoned estimate
  and probes back; the n-gram lane runs no draft step; the per-k windows
  attribute each dispatch to its rung and ``reset`` re-bases them; a
  rung thrash prepares no program;
* ``distill_draft`` on the same raw draft and the same teacher rollouts
  gives the JAX package's losses within 1e-4 relative and its agreement
  within one token, and lifts the port's serve-time acceptance.

Weights: tests/torch_spec_setup.py.
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.inference.spec_controller import (
    SpecController, expected_tokens_per_verify)
from paddle_tpu_torch.models import decode_engine as PD

from torch_paged_setup import weights
from torch_spec_setup import (BS, DD, DRAFT, END_ID, E, H, KW, L, N_SLOTS,
                              NB, PROMPT_POOL, S, V, jax_pool_oracle,
                              jax_scope, pool_rows, port_scope, serve,
                              train_pair)

LADDER = (0, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Scripted:
    """A controller replaying a fixed k schedule: the rung sequence is a
    test input, not a policy outcome."""

    def __init__(self, schedule):
        self.schedule = list(schedule)
        self.i = 0
        self.observed = []

    def choose(self):
        k = self.schedule[min(self.i, len(self.schedule) - 1)]
        self.i += 1
        return int(k)

    def observe(self, accepted_delta, ticks_delta, k):
        self.observed.append((int(np.asarray(accepted_delta).sum()),
                              int(np.asarray(ticks_delta).sum()), int(k)))

    def reset_lane(self, lane):
        pass

    def stats(self):
        return {"scripted": True, "chosen": self.i}


# --- the controller's policy (host logic only) ----------------------------
class TestControllerPolicy:
    def test_expected_tokens_per_verify(self):
        assert expected_tokens_per_verify(0.0, 4) == 1.0
        assert expected_tokens_per_verify(1.0, 4) == 5.0
        assert expected_tokens_per_verify(0.5, 2) == pytest.approx(1.75)

    @staticmethod
    def _feed(ctl, a, k, times=8):
        for _ in range(times):
            ctl.observe(np.full(4, a * 10 * k), np.full(4, 10), k=k)

    def test_climbs_on_high_acceptance(self):
        ctl = SpecController(LADDER, default_k=2, probe_every=0)
        assert ctl.choose() == 2  # no signal: the default rung
        self._feed(ctl, 0.95, 2)
        assert ctl.choose() == 4
        assert ctl.k_now == 4 and ctl.n_switches == 1

    def test_parks_at_zero_on_garbage(self):
        ctl = SpecController(LADDER, default_k=2, probe_every=0)
        self._feed(ctl, 0.0, 2)
        assert ctl.choose() == 0
        a = ctl.acceptance
        ctl.observe(np.zeros(4), np.full(4, 10), k=0)
        assert ctl.acceptance == a and ctl.choose() == 0

    def test_probe_escapes_the_park(self):
        ctl = SpecController(LADDER, default_k=2, probe_every=3)
        self._feed(ctl, 0.0, 2)
        assert ctl.choose() == 0
        seen = [ctl.choose() for _ in range(6)]
        assert 2 in seen and ctl.n_probes >= 1
        self._feed(ctl, 0.95, 2)
        assert ctl.choose() == 4

    def test_hysteresis_holds_near_ties(self):
        ctl = SpecController(LADDER, default_k=2, margin=0.5,
                             probe_every=0)
        self._feed(ctl, 0.6, 2)
        assert ctl.choose() == 2 and ctl.n_switches == 0

    def test_lane_tracking_and_reset(self):
        ctl = SpecController(LADDER, default_k=2)
        ctl.observe(np.array([20.0, 0.0]), np.array([10.0, 10.0]), k=2)
        rates = ctl.lane_rates()
        assert rates[0] == 1.0 and rates[1] == 0.0
        ctl.reset_lane(0)
        assert 0 not in ctl.lane_rates()
        st = ctl.stats()
        assert st["k_now"] == 2 and st["k_options"] == list(LADDER)

    def test_default_k_joins_the_ladder(self):
        assert SpecController((0, 4), default_k=2).k_options == (0, 2, 4)
        assert SpecController((), default_k=2).k_options == (2,)

    def test_policy_equals_the_jax_controller(self):
        """The same observation stream through both packages' classes
        gives the same choices, estimates and stats."""
        from paddle_tpu.inference.spec_controller import \
            SpecController as JaxController

        rng = np.random.RandomState(0)
        a, b = (cls(LADDER, default_k=2, probe_every=4, ewma=0.5)
                for cls in (SpecController, JaxController))
        for _ in range(40):
            k = a.choose()
            assert k == b.choose()
            acc = rng.binomial(10 * max(k, 1), rng.rand(), 5)
            for c in (a, b):
                c.observe(acc, np.full(5, 10), k=k)
            if rng.rand() < 0.2:
                lane = int(rng.randint(5))
                a.reset_lane(lane)
                b.reset_lane(lane)
        assert a.stats() == b.stats()


# --- the ladder's serves --------------------------------------------------
@pytest.fixture(scope="module")
def world():
    params = train_pair()
    built = {}
    ladder = PD.DraftConfig(k=2, k_options=LADDER, **DRAFT)
    for name, draft, cache in (
            ("adapt", ladder, None),
            ("padapt", ladder, PD.CacheConfig("paged", BS, NB, E)),
            ("ngram", PD.DraftConfig(k=2, kind="ngram", ngram=2,
                                     k_options=(0, 2)), None)):
        with unique_name.guard():
            built[name] = PD.build_decode_step_program(
                n_slots=N_SLOTS, admit_buckets=[N_SLOTS],
                state_prefix=f"@{name}/", draft=draft, cache=cache, **KW)
    return dict(params=params, oracle=jax_pool_oracle(params),
                scope=port_scope(params), exe=pf.Executor(pf.CPUPlace()),
                **built)


def _server(world, bundle, ctl=None, **kw):
    return PS.ContinuousGenerationServer(
        world[bundle] if isinstance(bundle, str) else bundle,
        executor=world["exe"], scope=world["scope"], start=False,
        spec_controller=ctl, **kw)


def _wave(world, seed, n):
    rows = pool_rows(np.random.RandomState(seed), n)
    return PROMPT_POOL[rows], world["oracle"][rows]


@pytest.mark.parametrize("kv", LADDER)
def test_token_exact_at_each_rung(world, kv):
    srcs, want = _wave(world, 11 + kv, 8)
    got, st = serve(_server(world, "adapt", _Scripted([kv])), srcs)
    np.testing.assert_array_equal(got, want)
    per_k = st["speculative"]["per_k"]
    assert per_k[kv]["dispatches"] > 0
    assert all(per_k[o]["dispatches"] == 0 for o in LADDER if o != kv)
    tel = st["device_telemetry"]
    assert tel[f"spec_ticks_k{kv}"] > 0
    if kv == 0:
        # the plain rung proposes nothing; the draft's keepalive step
        # wrote its cache (zeroed when the server seeded the slot state)
        assert per_k[0]["proposed"] == 0
        assert st["speculative"]["draft_steps"] == 0
        assert world["scope"]._get("@adapt/draft_self_k0").abs().sum() > 0
    else:
        assert per_k[kv]["proposed"] > 0


def test_token_exact_across_midflight_switches(world):
    srcs, want = _wave(world, 17, 12)
    got, st = serve(_server(world, "adapt",
                            _Scripted([4, 0, 2, 0, 4, 2] * 50)), srcs)
    np.testing.assert_array_equal(got, want)
    per_k = st["speculative"]["per_k"]
    assert sum(1 for kv in LADDER if per_k[kv]["dispatches"] > 0) >= 2
    assert st["speculative"]["controller"]["scripted"] is True


def test_paged_ladder_switches_token_exact(world):
    """The paged server over a ladder bundle: block coverage sized by the
    top rung, hit and miss admissions, rung switches mid-flight, and the
    automatic controller."""
    srcs, want = _wave(world, 53, 10)
    srcs[4], want[4] = srcs[0], want[0]  # a prefix hit
    for ctl in (_Scripted([4, 0, 2] * 50), None):
        got, st = serve(PS.PagedContinuousGenerationServer(
            world["padapt"], executor=world["exe"], scope=world["scope"],
            start=False, spec_controller=ctl, steps_per_tick=3), srcs)
        np.testing.assert_array_equal(got, want)
        assert st["block_pool"]["blocks_in_use"] == 0
        assert st["block_pool"]["prefix_hits"] >= 1
    assert world["padapt"].tokens_per_tick == 5
    assert sum(w["dispatches"] > 0
               for w in st["speculative"]["per_k"].values()) >= 1


def test_auto_controller_holds_a_positive_rung(world):
    srcs, want = _wave(world, 19, 10)
    got, st = serve(_server(world, "adapt"), srcs)
    np.testing.assert_array_equal(got, want)
    ctl = st["speculative"]["controller"]
    assert ctl["k_options"] == list(LADDER)
    assert ctl["k_now"] in LADDER and ctl["k_now"] > 0
    assert ctl["acceptance_ewma"] is not None \
        and ctl["acceptance_ewma"] > 0.3


def test_parks_at_plain_and_probes_back(world):
    srcs, want = _wave(world, 23, 8)
    parked = SpecController(LADDER, default_k=2, probe_every=0)
    for _ in range(10):
        parked.observe(np.zeros(N_SLOTS + 1), np.full(N_SLOTS + 1, 10.0),
                       k=2)
    got, st = serve(_server(world, "adapt", parked), srcs)
    np.testing.assert_array_equal(got, want)
    per_k = st["speculative"]["per_k"]
    assert per_k[2]["dispatches"] == per_k[4]["dispatches"] == 0
    assert per_k[0]["dispatches"] > 0
    assert st["speculative"]["proposed"] == 0
    probing = SpecController(LADDER, default_k=2, probe_every=2, ewma=0.5)
    for _ in range(10):
        probing.observe(np.zeros(N_SLOTS + 1), np.full(N_SLOTS + 1, 10.0),
                        k=2)
    got2, st2 = serve(_server(world, "adapt", probing, steps_per_tick=2,
                              drain_steps=2), srcs)
    np.testing.assert_array_equal(got2, want)
    ctl = st2["speculative"]["controller"]
    assert ctl["probes"] >= 1
    assert st2["speculative"]["per_k"][2]["dispatches"] > 0
    assert ctl["acceptance_ewma"] > 0.1


def test_ngram_lane_is_token_exact_with_no_draft_step(world):
    srcs, want = _wave(world, 29, 10)
    got, st = serve(_server(world, "ngram"), srcs)
    np.testing.assert_array_equal(got, want)
    sp = st["speculative"]
    assert sp["draft_steps"] == 0 and sp["proposed"] > 0
    assert sp["acceptance_rate"] is not None and sp["acceptance_rate"] > 0.1
    assert sp["emitted"] == int(PS.count_generated_tokens(got, END_ID).sum())
    srcs2, want2 = _wave(world, 31, 8)
    got2, st2 = serve(_server(world, "ngram", _Scripted([2, 0] * 100)),
                      srcs2)
    np.testing.assert_array_equal(got2, want2)
    sp2 = st2["speculative"]
    assert sp2["draft_steps"] == 0
    assert sp2["per_k"][0]["dispatches"] > 0
    assert sp2["per_k"][2]["dispatches"] > 0


def test_per_k_windows_and_reset(world):
    srcs, _ = _wave(world, 37, 6)
    srv = _server(world, "adapt")
    try:
        for s in srcs:
            srv.submit(s)
        from torch_radix_setup import drive
        drive(srv)
        sp = srv.stats(reset=True)["speculative"]
        assert sorted(sp["per_k"]) == list(LADDER)
        ran = [kv for kv in LADDER
               if kv > 0 and sp["per_k"][kv]["proposed"] > 0]
        assert ran
        for kv in ran:
            w = sp["per_k"][kv]
            assert 0 <= w["accepted"] <= w["proposed"]
            assert w["acceptance_rate"] is not None
            assert w["acceptance_rate_hist"]["p50"] is not None
        assert sp["k_options"] == list(LADDER)
        sp2 = srv.stats()["speculative"]
        for kv in LADDER:
            assert sp2["per_k"][kv]["dispatches"] == 0
            assert sp2["per_k"][kv]["proposed"] == 0
        assert sp2["per_k"][ran[0]]["acceptance_rate_hist"]["p50"] is None
        assert sp2["proposed"] == 0
    finally:
        srv.close()


def test_rung_thrash_prepares_nothing(world, monkeypatch):
    """Every ("k", kv, base) serve is prepared when the server is built:
    a controller thrashing the rungs never prepares a program."""
    exe = world["exe"]
    prepared = []
    real = exe.prepare
    monkeypatch.setattr(exe, "prepare",
                        lambda *a, **k: prepared.append(1) or real(*a, **k))
    srv = _server(world, "adapt", _Scripted([2, 4, 0] * 1000))
    assert len(prepared) == len(world["adapt"].serves)
    srcs, want = _wave(world, 43, 16)
    got, st = serve(srv, srcs)
    np.testing.assert_array_equal(got, want)
    assert len(prepared) == len(world["adapt"].serves)
    assert exe.compile_count == 0
    assert all(st["speculative"]["per_k"][kv]["dispatches"] > 0
               for kv in LADDER)


def test_controller_needs_a_ladder_and_tokens_separate(world):
    with unique_name.guard():
        fixed = PD.build_decode_step_program(
            n_slots=2, state_prefix="@fx/", admit_buckets=[2],
            draft=PD.DraftConfig(k=2, **DRAFT), **KW)
    with pytest.raises(ValueError, match="k ladder"):
        _server(world, fixed, SpecController((0, 2), default_k=2))
    base = PD.DraftConfig(k=2, **DRAFT)
    tokens = {base.token(),
              PD.DraftConfig(k=2, k_options=LADDER, **DRAFT).token(),
              PD.DraftConfig(k=2, kind="ngram", ngram=2).token(),
              PD.DraftConfig(k=2, kind="ngram", ngram=3).token(),
              PD.DraftConfig(k=2, sharded=True, **DRAFT).token()}
    assert len(tokens) == 5
    assert world["adapt"].cache_token() != world["ngram"].cache_token()
    assert world["adapt"].spec_k_options == LADDER
    assert world["ngram"].spec_k_options == (0, 2)
    assert world["adapt"].tokens_per_tick == 5


# --- distillation -----------------------------------------------------------
def test_distillation_matches_jax_and_lifts_acceptance(world):
    """The same raw draft ("raw_", seeded) in both packages, the same
    teacher rollouts (the JAX whole loop's rows of the pool prompts):
    each round's loss within 1e-4 relative of the JAX run's and its
    agreement within one token of B x T. The port's serve-time
    acceptance rises by more than 0.1, the tokens do not move, and the
    target's parameters keep their values."""
    import paddle_tpu as jf
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.models.decode_engine import DraftConfig as JDraft
    from paddle_tpu.models.distill import distill_draft as jax_distill
    from paddle_tpu_torch.models import transformer as PT
    from paddle_tpu_torch.models.distill import distill_draft

    with unique_name.guard():
        _, r_st, _ = PT.build_program(
            seq_len=S, d_model=DD, n_heads=H, n_layers=L, d_inner=32,
            vocab=V, with_optimizer=False, dropout_rate=0.0,
            name_prefix="raw_")
    raw_params = {n: a for n, a in weights(r_st, seed=9).items()
                  if n.startswith("raw_")}
    scope = port_scope(dict(world["params"], **raw_params))
    raw = PD.DraftConfig(k=2, prefix="raw_", **DRAFT)
    with unique_name.guard():
        bundle = PD.build_decode_step_program(
            n_slots=N_SLOTS, state_prefix="@rw/", admit_buckets=[N_SLOTS],
            draft=raw, **KW)
    srcs, want = _wave(world, 47, 8)

    def serve_raw():
        return serve(PS.ContinuousGenerationServer(
            bundle, executor=world["exe"], scope=scope, start=False), srcs)

    got, st = serve_raw()
    np.testing.assert_array_equal(got, want)
    before = st["speculative"]["accepted"] / max(
        st["speculative"]["proposed"], 1)

    pool = {tuple(r): i for i, r in enumerate(PROMPT_POOL)}

    def teacher(b):
        return world["oracle"][[pool[tuple(r)] for r in b]]

    def prompts(rng, n):
        return PROMPT_POOL[pool_rows(rng, n)]

    target = {n: scope._get(n).clone() for n in world["params"]}
    cfg = dict(KW, rounds=6, batch=8, inner_steps=4, learning_rate=0.01,
               seed=3)
    res = distill_draft(world["exe"], scope, raw, teacher, prompts, **cfg)
    for n, t in target.items():
        assert torch.equal(scope._get(n), t), n

    jexe = jf.Executor(jf.CPUPlace())
    jlosses = []
    real = jexe.run_steps

    def run_steps(*a, **k):
        out = real(*a, **k)
        jlosses.append(float(np.asarray(out[0]).reshape(-1)[-1]))
        return out

    jexe.run_steps = run_steps
    with j_unique_name.guard():
        jres = jax_distill(
            jexe, jax_scope(dict(world["params"], **raw_params)),
            JDraft(k=2, prefix="raw_", **DRAFT),
            teacher, prompts, **cfg)
    np.testing.assert_allclose(res["loss"], jlosses, rtol=1e-4)
    tokens = cfg["batch"] * KW["max_out_len"]
    np.testing.assert_allclose(res["agree"], jres["agree"], rtol=0,
                               atol=1.0 / tokens + 1e-7)
    assert res["loss_last"] < res["loss_first"]

    got2, st2 = serve_raw()
    np.testing.assert_array_equal(got2, want)
    after = st2["speculative"]["accepted"] / max(
        st2["speculative"]["proposed"], 1)
    assert after > before + 0.1, (before, after)
