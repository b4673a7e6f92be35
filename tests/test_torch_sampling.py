"""The port's sampled emission on the CPU, against the JAX package:

* the port's threefry noise (ops/spec_ops.py) equals ``jax.random``'s
  bit for bit: ``fold_in`` chains, the 32-bit draws and the uniforms,
  at seeds 0, 1, 2^31+5, 2^32-1 and a crc32 and at several positions;
* the ``sample_categorical`` op's tokens equal the JAX op's on the same
  probabilities, and ``filtered_softmax`` lies within 1e-6 of the JAX
  package's ``_filter_probs`` over a temperature / top-k / top-p grid,
  ties and temperature 0 included; a chi-square test holds the draws to
  their probabilities;
* the sampled dense and paged servers' tokens equal the JAX package's
  servers' on the same weights, prompts and seeds; admission order and
  burst length move no token, other seeds move the stream, ``n_best``
  branch i draws with seed + i; sampled and greedy bundles never share a
  ``cache_token``.

Weights and prompts: tests/torch_paged_setup.py. Both packages' servers
are driven on the calling thread.
"""
import zlib

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch import layers, unique_name
from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.models import decode_engine as PD
from paddle_tpu_torch.ops import spec_ops as SO

from torch_paged_setup import MODEL, PortModel, jax_scope, prompts
from torch_radix_setup import drive

N_SLOTS = 4
SAMPLING = dict(temperature=0.8, top_k=8, top_p=0.9, base_seed=11)
SEEDS = [0, 1, 2 ** 31 + 5, 2 ** 32 - 1,
         zlib.crc32(b"paddle_tpu_torch"), 77]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_key_words(key):
    return [int(x) for x in np.asarray(key).astype(np.int64)]


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_threefry_matches_jax_random(seed):
    """fold_in chains, bits and [tiny, 1) uniforms, bit for bit."""
    for base_seed, tag in ((0, 0), (11, 0), (2 ** 31 - 1, 101),
                           (2 ** 33 + 3, 102)):
        jb = jax.random.fold_in(
            jax.random.PRNGKey(base_seed & 0x7FFFFFFF), tag)
        pb = SO.base_key(base_seed, tag)
        assert _jax_key_words(jb) == [int(pb[0]), int(pb[1])]
    pos = np.array([0, 1, 5, 31, 255, 2 ** 31 + 1], np.int64)
    seeds = np.full(pos.shape, seed, np.int64)
    base = jax.random.fold_in(jax.random.PRNGKey(11), 0)
    jk = jax.vmap(lambda s, p: jax.random.fold_in(
        jax.random.fold_in(base, s), p))(
        jnp.asarray(seeds.astype(np.uint32)),
        jnp.asarray(pos.astype(np.uint32)))
    pk = SO.lane_keys(SO.base_key(11, 0), torch.from_numpy(seeds),
                      torch.from_numpy(pos))
    np.testing.assert_array_equal(
        np.asarray(jk).astype(np.int64),
        np.stack([pk[0].numpy(), pk[1].numpy()], axis=1))
    for n in (1, 50, 1000):
        jbits = jax.vmap(lambda k: jax.random.bits(k, (n,)))(jk)
        np.testing.assert_array_equal(np.asarray(jbits).astype(np.int64),
                                      SO.random_bits(pk, n).numpy())
        ju = jax.vmap(lambda k: jax.random.uniform(
            k, (n,), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))(jk)
        np.testing.assert_array_equal(np.asarray(ju),
                                      SO.uniform(pk, n).numpy())


def _logits(rng, r, v, ties=False):
    x = rng.randn(r, v).astype(np.float32) * 2
    if ties:
        # quantized logits: many exact ties, at the top-k boundary too
        x = np.round(x * 2) / 2
    return x


def test_filtered_softmax_matches_filter_probs():
    from paddle_tpu.ops import spec_ops as JSO

    rng = np.random.RandomState(0)
    v = 40
    for ties in (False, True):
        x = _logits(rng, 6, v, ties)
        for t in (0.0, 0.5, 1.0, 1.7):
            for k in (0, 1, 3, 8, v):
                for p in (1.0, 0.9, 0.3, 1e-3):
                    want = np.asarray(JSO._filter_probs(
                        jnp.asarray(x), t, k, p))
                    got = SO.filter_probs(torch.from_numpy(x), t, k,
                                          p).numpy()
                    np.testing.assert_allclose(
                        got, want, rtol=0, atol=1e-6,
                        err_msg=f"ties={ties} t={t} k={k} p={p}")
                    assert ((got > 0) == (want > 0)).all()
    # the op, through a program
    main = pf.Program()
    with pf.program_guard(main, pf.Program()):
        xv = layers.data("x", shape=[6, v], dtype="float32",
                         append_batch_size=False)
        out = layers.filtered_softmax(xv, temperature=0.7, top_k=5,
                                      top_p=0.8)
    got = pf.Executor(pf.CPUPlace()).run(main, feed={"x": x},
                                         fetch_list=[out])[0]
    np.testing.assert_allclose(
        got, np.asarray(JSO._filter_probs(jnp.asarray(x), 0.7, 5, 0.8)),
        rtol=0, atol=1e-6)


def _sample_program(pkg, r, v, base_seed, tag):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        probs = pkg.layers.data("probs", shape=[r, v], dtype="float32",
                                append_batch_size=False)
        seed = pkg.layers.data("seed", shape=[r], dtype="int64",
                               append_batch_size=False)
        pos = pkg.layers.data("pos", shape=[r], dtype="int64",
                              append_batch_size=False)
        tok = pkg.layers.sample_categorical(probs, seed, pos,
                                            noise_tag=tag,
                                            base_seed=base_seed)
    return main, tok


def test_sample_categorical_matches_jax_op():
    import paddle_tpu as jf
    from paddle_tpu.ops import spec_ops as JSO

    rng = np.random.RandomState(1)
    r, v = 12, 50
    probs = np.asarray(JSO._filter_probs(
        jnp.asarray(_logits(rng, r, v)), 1.0, 10, 0.95))
    seeds = np.array(SEEDS * 2, np.int64)
    pos = np.arange(1, r + 1, dtype=np.int64) * 7
    feed = {"probs": probs, "seed": seeds, "pos": pos}
    for base_seed, tag in ((0, 0), (11, 0), (5, 101)):
        with unique_name.guard():
            pm, pt = _sample_program(pf, r, v, base_seed, tag)
        jm, jt = _sample_program(jf, r, v, base_seed, tag)
        got = pf.Executor(pf.CPUPlace()).run(pm, feed=feed,
                                             fetch_list=[pt])[0]
        want = jf.Executor(jf.CPUPlace()).run(jm, feed=feed,
                                              fetch_list=[jt])[0]
        np.testing.assert_array_equal(got, np.asarray(want))
        assert (probs[np.arange(r), got] > 0).all()


def test_draws_follow_their_probabilities():
    """10000 draws (seeds 0..9999 at one position) from a fixed
    distribution over 8 tokens, one of them at probability 0, which is
    never drawn: the chi-square statistic of the other 7 below the 0.999
    quantile of 6 degrees of freedom."""
    from scipy import stats

    p = np.array([0.3, 0.2, 0.15, 0.12, 0.1, 0.08, 0.05, 0.0], np.float32)
    n = 10000
    probs = torch.from_numpy(np.tile(p, (n, 1)))
    keys = SO.lane_keys(SO.base_key(3, 0), torch.arange(n),
                        torch.full((n,), 9))
    tok = SO.gumbel_argmax(keys, torch.log(probs + 1e-20)).numpy()
    counts = np.bincount(tok, minlength=8)
    assert counts[7] == 0
    exp = n * p[:7].astype(np.float64)
    chi2 = float(((counts[:7] - exp) ** 2 / exp).sum())
    assert chi2 < stats.chi2.ppf(0.999, 6), (chi2, counts)


# --- the servers ------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    m = PortModel()
    samp = PD.SamplingConfig(**SAMPLING)
    with unique_name.guard():
        dense = PD.build_decode_step_program(
            n_slots=N_SLOTS, admit_buckets=[1, 4], sampling=samp,
            **MODEL)
    with unique_name.guard():
        paged = PD.build_decode_step_program(
            n_slots=N_SLOTS, admit_buckets=[1, 4], sampling=samp,
            state_prefix="@sp/",
            cache=PD.CacheConfig("paged", 8, N_SLOTS * 4, 3), **MODEL)
    srcs = prompts(5, 12)[:len(SEEDS)]
    return dict(m=m, dense=dense, paged=paged, srcs=srcs,
                greedy=m.decode(srcs))


def _submit_all(srv, srcs, seeds, order):
    replies = {i: srv.submit(srcs[i], seed=seeds[i]) for i in order}
    drive(srv)
    return np.stack([np.asarray(replies[i].result(timeout=0))
                     for i in range(len(srcs))])


def _port_server(world, kind, **kw):
    cls = PS.PagedContinuousGenerationServer if kind == "paged" \
        else PS.ContinuousGenerationServer
    return cls(world[kind], executor=world["m"].exe,
               scope=world["m"].scope, start=False, **kw)


@pytest.fixture(scope="module")
def port_rows(world):
    out = {}
    for kind in ("dense", "paged"):
        srv = _port_server(world, kind, steps_per_tick=8)
        try:
            out[kind] = _submit_all(srv, world["srcs"], SEEDS,
                                    range(len(SEEDS)))
        finally:
            srv.close()
    return out


def test_sampled_servers_match_jax_servers(world, port_rows):
    import paddle_tpu as jf
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.inference import serving as JS
    from paddle_tpu.models import decode_engine as JD
    from paddle_tpu.models import transformer as JT

    samp = JD.SamplingConfig(**SAMPLING)
    exe = jf.Executor(jf.CPUPlace())
    for kind in ("dense", "paged"):
        kw = dict(state_prefix="@sp/",
                  cache=JD.CacheConfig("paged", 8, N_SLOTS * 4, 3)) \
            if kind == "paged" else {}
        with j_unique_name.guard():
            jb = JT.build_decode_step_program(
                n_slots=N_SLOTS, admit_buckets=[1, 4], sampling=samp,
                **kw, **MODEL)
        assert jb.cache_token() == world[kind].cache_token()
        for key in jb.serves:
            assert world[kind].serve_feed_spec(key) \
                == jb.serve_feed_spec(key), key
        assert world[kind].state == jb.state
        cls = JS.PagedContinuousGenerationServer if kind == "paged" \
            else JS.ContinuousGenerationServer
        srv = cls(jb, executor=exe, scope=jax_scope(world["m"].params),
                  start=False, steps_per_tick=8)
        try:
            want = _submit_all(srv, world["srcs"], SEEDS,
                               range(len(SEEDS)))
        finally:
            srv.close()
        np.testing.assert_array_equal(port_rows[kind], want, err_msg=kind)
    # the draws moved the stream off the greedy decode
    assert (port_rows["paged"] != world["greedy"]).any()


def test_order_and_burst_length_move_no_token(world, port_rows):
    n = len(SEEDS)
    for kind in ("dense", "paged"):
        srv = _port_server(world, kind, steps_per_tick=3)
        try:
            got = _submit_all(srv, world["srcs"], SEEDS,
                              list(reversed(range(n))))
            # the same prompts again: a sampled bundle takes no plain
            # radix reuse, and draws the same tokens from the same seeds
            again = _submit_all(srv, world["srcs"], SEEDS, range(n))
        finally:
            srv.close()
        np.testing.assert_array_equal(got, port_rows[kind], err_msg=kind)
        np.testing.assert_array_equal(again, port_rows[kind], err_msg=kind)


def test_seeds_key_the_stream(world, port_rows):
    srcs = world["srcs"]
    srv = _port_server(world, "paged", steps_per_tick=8)
    try:
        other = _submit_all(srv, srcs, [s + 1000 for s in SEEDS],
                            range(len(SEEDS)))
        # default seed: crc32 of the prompt's int64 bytes
        r = srv.submit(srcs[0])
        r_seeded = srv.submit(srcs[0],
                              seed=zlib.crc32(srcs[0][None].tobytes()))
        # n_best: branch i draws with seed + i
        branches = srv.submit(srcs[1], seed=40, n_best=3)
        singles = [srv.submit(srcs[1], seed=40 + i) for i in range(3)]
        drive(srv)
        ps = srv.pool_stats()
    finally:
        srv.close()
    assert (other != port_rows["paged"]).any(axis=1).sum() >= 3
    np.testing.assert_array_equal(r.result(timeout=0),
                                  r_seeded.result(timeout=0))
    b = [np.asarray(x.result(timeout=0)) for x in branches]
    for got, want in zip(b, singles):
        np.testing.assert_array_equal(got, want.result(timeout=0))
    assert not (np.array_equal(b[0], b[1]) and np.array_equal(b[1], b[2]))
    assert ps["plain_radix_admissions"] == 0
    assert ps["blocks_in_use"] == 0 or ps["radix_nodes"] > 0


def test_sampled_and_greedy_bundles_never_share_a_cache_token(world):
    m = world["m"]
    cache = PD.CacheConfig("paged", 8, N_SLOTS * 4, 3)
    greedy = m.bundle(N_SLOTS, cache, admit_buckets=[1])
    toks = {greedy.cache_token(), world["paged"].cache_token()}
    for cfg in (dict(SAMPLING, temperature=0.9), dict(SAMPLING, top_k=0),
                dict(SAMPLING, base_seed=12), dict(temperature=0.0)):
        with unique_name.guard():
            b = PD.build_decode_step_program(
                n_slots=N_SLOTS, admit_buckets=[1], cache=cache,
                sampling=PD.SamplingConfig(**cfg), **MODEL)
        toks.add(b.cache_token())
    assert len(toks) == 6
    assert greedy.cache_token() == cache.token()
    assert not greedy.needs_seeds and world["paged"].needs_seeds
    with pytest.raises(ValueError, match="top_p"):
        PD.SamplingConfig(top_p=0.0).validate()
    with pytest.raises(ValueError, match="temperature"):
        PD.SamplingConfig(temperature=-1.0).validate()


def test_temperature_zero_is_greedy(world):
    """A temperature-0 bundle feeds seeds but emits the argmax: the
    whole-loop greedy decode's rows."""
    with unique_name.guard():
        b = PD.build_decode_step_program(
            n_slots=N_SLOTS, admit_buckets=[1, 4],
            sampling=PD.SamplingConfig(temperature=0.0),
            state_prefix="@t0/",
            cache=PD.CacheConfig("paged", 8, N_SLOTS * 4, 3), **MODEL)
    assert b.needs_seeds
    srv = PS.PagedContinuousGenerationServer(
        b, executor=world["m"].exe, scope=world["m"].scope, start=False)
    try:
        got = _submit_all(srv, world["srcs"], SEEDS, range(len(SEEDS)))
    finally:
        srv.close()
    np.testing.assert_array_equal(got, world["greedy"])


def test_beam_decoder_over_a_sampled_bundle(world):
    """The beam decoder feeds a sampled bundle's admissions zero seeds;
    its probe ticks never sample, so its hypotheses are those of the
    same decoder over a greedy bundle."""
    m = world["m"]
    greedy = m.bundle(N_SLOTS, PD.CacheConfig("paged", 8, N_SLOTS * 4, 3),
                      admit_buckets=[1, 4], state_prefix="@bg/")
    src = world["srcs"][2]
    out = []
    for b in (world["paged"], greedy):
        dec = PS.PagedBeamDecoder(b, 3, executor=m.exe, scope=m.scope)
        out.append(dec.decode(src, return_all=True))
    for (t1, s1), (t2, s2) in zip(*out):
        np.testing.assert_array_equal(t1, t2)
        assert s1 == s2
