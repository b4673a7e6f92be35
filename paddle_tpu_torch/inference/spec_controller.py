"""The adaptive speculation controller: the port's copy of
``paddle_tpu/inference/spec_controller.py`` (host policy, pure Python).

Every serve program of a bundle is prepared before traffic, so
"adaptive" does not mean building a program at a new k. It means
choosing, for each fused dispatch, which rung of the ladder the bundle
already built (``DraftConfig.k_options``, the ``("k", kv, base)`` serve
keys) the whole slot pool runs next.

The signal is the per-lane counter pair the speculative step maintains
(``spec_lane_accepted`` and ``spec_lane_ticks``, cumulative int64 rows
fetched with every dispatch): the server deltas them and feeds
``observe()``; ``choose()`` returns the rung that maximizes the expected
tokens a unit of target cost,

    score(k) = E[tokens/verify] / (1 + c * k),
    E[tokens/verify] = (1 - a^(k+1)) / (1 - a)   (a < 1; k+1 at a = 1)

with ``a`` the pooled EWMA acceptance of a proposed token and ``c`` the
draft/target cost ratio of one step (0 for the model-free n-gram lane).
As ``a`` falls the choice walks down the ladder and parks at k = 0 (the
plain one-token step); a parked controller probes a positive rung every
``probe_every`` choices, so recovering traffic is seen. A switch needs a
relative score gain above ``margin`` (hysteresis against noisy small
windows).

``choose_draft_placement`` takes a tensor-parallel ``ShardingConfig``
and belongs to serving step 10 of the port.
"""
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["SpecController", "expected_tokens_per_verify"]


def expected_tokens_per_verify(a: float, k: int) -> float:
    """E[tokens emitted a verify step] at acceptance ``a`` and draft
    length ``k``: the accepted geometric prefix plus the correction or
    bonus token, sum_{i=0..k} a^i = (1 - a^(k+1)) / (1 - a)."""
    a = min(max(float(a), 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


class SpecController:
    """Per-lane acceptance EWMA and a pooled choice of k over a fixed
    ladder. Host policy only: a decision picks one of the prepared serve
    programs and can never cause a program to be built.

    k_options: the bundle's ladder; the default k joins it.
    default_k: the rung the bundle's plain serve keys run.
    draft_cost_ratio: ``c`` of the score's denominator ``1 + c*k`` (0 for
        n-gram lanes).
    ewma: the weight of the newest window in the acceptance estimate.
    margin: the relative score gain needed to leave the current rung.
    probe_every: parked at k = 0, one positive-rung dispatch every this
        many choices.
    """

    def __init__(self, k_options: Sequence[int], default_k: int,
                 draft_cost_ratio: float = 0.25,
                 ewma: float = 0.25,
                 margin: float = 0.05,
                 probe_every: int = 16):
        opts = sorted({int(k) for k in k_options})
        if int(default_k) not in opts:
            opts.append(int(default_k))
            opts.sort()
        if not opts:
            raise ValueError("k_options must be non-empty")
        self.k_options: Tuple[int, ...] = tuple(opts)
        self.default_k = int(default_k)
        self.draft_cost_ratio = float(draft_cost_ratio)
        self.ewma = float(ewma)
        self.margin = float(margin)
        self.probe_every = int(probe_every)
        self._a: Optional[float] = None       # pooled EWMA acceptance
        self._lane_a: Dict[int, float] = {}   # per-lane EWMA
        self._k = self.default_k
        self._parked = 0                      # choices spent at k = 0
        self.n_switches = 0
        self.n_probes = 0

    def observe(self, accepted_delta, ticks_delta, k: int):
        """Absorb one dispatch's per-lane counter deltas (arrays over the
        slot pool, dustbin row included) taken while the pool ran rung
        ``k``. A k = 0 dispatch proposes nothing and leaves the estimate
        as it was."""
        if k <= 0:
            return
        acc = np.asarray(accepted_delta, dtype=np.float64).reshape(-1)
        tks = np.asarray(ticks_delta, dtype=np.float64).reshape(-1)
        tot_t = float(tks.sum())
        if tot_t <= 0:
            return
        for lane in np.nonzero(tks > 0)[0]:
            a_l = min(acc[lane] / (tks[lane] * k), 1.0)
            prev = self._lane_a.get(int(lane))
            self._lane_a[int(lane)] = a_l if prev is None else \
                (1 - self.ewma) * prev + self.ewma * a_l
        a_now = min(float(acc.sum()) / (tot_t * k), 1.0)
        self._a = a_now if self._a is None else \
            (1 - self.ewma) * self._a + self.ewma * a_now

    def reset_lane(self, lane: int):
        """A slot was admitted again: its history describes the retired
        request, so it goes (the pooled estimate decays by itself)."""
        self._lane_a.pop(int(lane), None)

    def score(self, k: int, a: Optional[float] = None) -> float:
        a = self._a if a is None else a
        if a is None:
            # no signal yet: the default rung
            return 1.0 if k == self.default_k else 0.0
        return expected_tokens_per_verify(a, k) \
            / (1.0 + self.draft_cost_ratio * k)

    def choose(self) -> int:
        """The rung the next dispatch runs."""
        if self._k == 0 and self.probe_every > 0:
            self._parked += 1
            if self._parked >= self.probe_every:
                self._parked = 0
                self.n_probes += 1
                pos = [k for k in self.k_options if k > 0]
                if pos:
                    return min(pos)  # a cheap probe; the estimate updates
        best = max(self.k_options, key=lambda k: (self.score(k), k))
        if best != self._k \
                and self.score(best) \
                > self.score(self._k) * (1.0 + self.margin):
            self._k = best
            self.n_switches += 1
            if best != 0:
                self._parked = 0
        return self._k

    @property
    def k_now(self) -> int:
        return self._k

    @property
    def acceptance(self) -> Optional[float]:
        return self._a

    def lane_rates(self) -> Dict[int, float]:
        return dict(self._lane_a)

    def stats(self) -> dict:
        return {
            "k_now": self._k,
            "k_options": list(self.k_options),
            "acceptance_ewma": (round(self._a, 4)
                                if self._a is not None else None),
            "switches": self.n_switches,
            "probes": self.n_probes,
            "lane_acceptance": {
                lane: round(v, 4)
                for lane, v in sorted(self._lane_a.items())},
        }
