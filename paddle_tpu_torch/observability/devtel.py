"""Device-side decode counters (the port's copy of the parts of
``paddle_tpu/observability/devtel.py`` that the decode bundles and the
continuous servers use).

Every counter is a ``[1]`` int64 persistable of a decode bundle, marked
``@TEL`` in its name, that the bundle's programs read-modify-write
(``var = var + delta``): ticks run, the live-lane occupancy integral,
which exit ended each burst, and how many lanes each admission flavor
admitted. The counters are cumulative since ``init_slot_state``; the
servers fetch them with every dispatch and ``DeviceTelemetry`` turns
them into per-dispatch deltas and ``stats()`` windows.

``BUNDLE_COUNTERS`` is the one table of names: the decode builder's
slot-state specs and state map, and the servers' fetch lists, all come
from it. A speculative bundle with a k ladder adds one tick counter a
rung (``spec_k_counter_specs``). ``HOST_COUNTERS`` are the paged
scheduler's host-side supplement (block and prompt-entry high-water marks,
pause and preemption events): host decisions the device cannot see that
explain the same slow bursts, so they share the ``device_telemetry``
stats and the ``paddle_tpu_devtel_*`` metric names.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

TEL_MARK = "@TEL"

# burst exit reasons, in reporting order (a serve program bumps one a
# burst)
EXIT_REASONS = ("n_steps", "all_idle", "min_active")


@dataclass(frozen=True)
class CounterSpec:
    """One device counter: its logical name (the key in
    ``bundle.state``), its metric name, its key in
    ``stats()['device_telemetry']``, and where it applies."""

    logical: str
    metric: str
    stat: str
    doc: str
    paged_only: bool = False
    chunked_only: bool = False


# the counters a decode bundle carries, in fetch order
BUNDLE_COUNTERS: Tuple[CounterSpec, ...] = (
    CounterSpec("tel_ticks", "paddle_tpu_devtel_ticks_total", "ticks",
                "step-body runs (device While iterations)"),
    CounterSpec("tel_occupancy",
                "paddle_tpu_devtel_occupancy_integral_total",
                "occupancy_integral",
                "sum over ticks of the live lanes at tick start"),
    CounterSpec("tel_exit_n_steps", "paddle_tpu_devtel_exit_n_steps_total",
                "exit_n_steps", "bursts that ran all n_steps ticks"),
    CounterSpec("tel_exit_all_idle",
                "paddle_tpu_devtel_exit_all_idle_total", "exit_all_idle",
                "bursts that ended with every lane idle"),
    CounterSpec("tel_exit_min_active",
                "paddle_tpu_devtel_exit_min_active_total",
                "exit_min_active",
                "bursts that ended when live lanes dropped to "
                "min_active"),
    CounterSpec("tel_admit_miss", "paddle_tpu_devtel_admit_miss_total",
                "admitted_miss",
                "lanes admitted through an encoder (miss) body"),
    CounterSpec("tel_admit_hit", "paddle_tpu_devtel_admit_hit_total",
                "admitted_hit",
                "lanes admitted through the encoder-free prefix-hit "
                "body", paged_only=True),
    CounterSpec("tel_admit_radix", "paddle_tpu_devtel_admit_radix_total",
                "admitted_radix",
                "lanes admitted through the radix-resume body",
                paged_only=True),
    CounterSpec("tel_cow_blocks", "paddle_tpu_devtel_cow_blocks_total",
                "cow_blocks", "KV blocks copied by the COW program",
                paged_only=True),
    CounterSpec("tel_chunks", "paddle_tpu_devtel_prefill_chunks_total",
                "prefill_chunks",
                "prompt chunks run by chunked-prefill programs",
                paged_only=True, chunked_only=True),
    CounterSpec("tel_prefill_occupancy",
                "paddle_tpu_devtel_prefill_occupancy_integral_total",
                "prefill_occupancy_integral",
                "live decode lanes summed over chunk dispatches",
                paged_only=True, chunked_only=True),
)


# the paged server's host-side counters: `stat` is its stats key and
# the name of the count it reads
HOST_COUNTERS: Tuple[CounterSpec, ...] = (
    CounterSpec("host_blocks_hwm", "paddle_tpu_devtel_blocks_hwm",
                "blocks_hwm",
                "high-water mark of KV blocks in use (window-scoped: "
                "stats(reset=True) re-bases it to the current "
                "residency)", paged_only=True),
    CounterSpec("host_prompt_entries_hwm",
                "paddle_tpu_devtel_prompt_entries_hwm",
                "prompt_entries_hwm",
                "high-water mark of prompt-pool entries in use",
                paged_only=True),
    CounterSpec("host_pause_events",
                "paddle_tpu_devtel_pause_events_total",
                "pause_events",
                "lanes parked for >= 1 cycle by pool pressure",
                paged_only=True),
    CounterSpec("host_preemptions",
                "paddle_tpu_devtel_preemptions_total", "preemptions",
                "recompute-preempted lanes (vLLM-style requeue)",
                paged_only=True),
)


def bundle_counters(paged: bool,
                    chunked: bool = True) -> Tuple[CounterSpec, ...]:
    """The counters a bundle of the given layout carries (``chunked``
    False for a bundle without chunked-prefill programs)."""
    return tuple(c for c in BUNDLE_COUNTERS
                 if (paged or not c.paged_only)
                 and (chunked or not c.chunked_only))


def counter_specs(prefix: str, paged: bool,
                  chunked: bool = False) -> Dict[str, tuple]:
    """Slot-state spec entries (name -> ((1,), 'int64'))."""
    return {f"{prefix}{c.logical}{TEL_MARK}": ((1,), "int64")
            for c in bundle_counters(paged, chunked)}


def state_entries(prefix: str, paged: bool,
                  chunked: bool = False) -> Dict[str, str]:
    """logical -> var name entries of ``DecodeStepBundle.state``."""
    return {c.logical: f"{prefix}{c.logical}{TEL_MARK}"
            for c in bundle_counters(paged, chunked)}


_SPEC_K_STEM = "tel_spec_ticks_k"


def spec_k_logical(k: int) -> str:
    """Logical name of the per-k speculative tick counter, bumped once
    a step-body run of the serve variant built at draft length k: the
    rungs of the adaptive ladder that ran, seen from the device."""
    return f"{_SPEC_K_STEM}{int(k)}"


def spec_k_counter_specs(prefix: str,
                         k_options: Iterable[int]) -> Dict[str, tuple]:
    """Slot-state spec entries of the per-k tick counters, one a rung of
    the bundle's ladder ([1] int64, @TEL-marked as counter_specs')."""
    return {f"{prefix}{spec_k_logical(k)}{TEL_MARK}": ((1,), "int64")
            for k in k_options}


def spec_k_state_entries(prefix: str,
                         k_options: Iterable[int]) -> Dict[str, str]:
    """logical -> var name entries of ``DecodeStepBundle.state`` for the
    per-k tick counters."""
    return {spec_k_logical(k): f"{prefix}{spec_k_logical(k)}{TEL_MARK}"
            for k in k_options}


class DeviceTelemetry:
    """The servers' half of the counters: ``absorb(values)`` takes one
    dispatch's fetched values (in ``fetch_names`` order) and returns its
    deltas; ``window()`` gives the totals since the last ``rebase()``
    (the ``stats(reset=True)`` window). Not thread-safe by itself: the
    servers call it under their scheduler lock."""

    def __init__(self, bundle):
        paged = getattr(getattr(bundle, "cache", None), "layout",
                        "dense") == "paged"
        state = getattr(bundle, "state", {}) or {}
        self._counters = [(c.logical, state[c.logical])
                          for c in bundle_counters(paged)
                          if c.logical in state]
        self._metric_by_logical = {
            c.logical: c.metric for c in BUNDLE_COUNTERS}
        # the ladder's per-k tick counters join sorted by k
        for logical in sorted(
                (n for n in state if n.startswith(_SPEC_K_STEM)),
                key=lambda n: int(n[len(_SPEC_K_STEM):])):
            self._counters.append((logical, state[logical]))
            self._metric_by_logical[logical] = \
                f"paddle_tpu_devtel_spec_ticks_k" \
                f"{logical[len(_SPEC_K_STEM):]}_total"
        self.totals: Dict[str, int] = {
            logical: 0 for logical, _ in self._counters}
        self._base: Dict[str, int] = dict(self.totals)

    @property
    def active(self) -> bool:
        return bool(self._counters)

    @property
    def fetch_names(self) -> List[str]:
        return [name for _, name in self._counters]

    def absorb(self, values: Iterable) -> Dict[str, int]:
        deltas = {}
        for (logical, _name), v in zip(self._counters, values):
            val = int(np.asarray(v).reshape(-1)[0])
            deltas[logical] = val - self.totals[logical]
            self.totals[logical] = val
        return deltas

    def window(self) -> Dict[str, int]:
        return {logical: self.totals[logical] - self._base[logical]
                for logical, _ in self._counters}

    def rebase(self):
        self._base = dict(self.totals)

    @staticmethod
    def exit_reason(deltas: Dict[str, int]) -> Optional[str]:
        """Which exit ended a dispatch's burst ('n_steps', 'all_idle' or
        'min_active') from its deltas; None when no burst ran."""
        for reason in EXIT_REASONS:
            if deltas.get(f"tel_exit_{reason}", 0) > 0:
                return reason
        return None

    def stats_dict(self, window: Dict[str, int]) -> dict:
        """``stats()['device_telemetry']`` from a window() snapshot: the
        counters under their stat keys and the mean live lanes."""
        by_logical = {c.logical: c.stat for c in BUNDLE_COUNTERS}
        # a per-k counter reads as spec_ticks_k<k>
        out = {by_logical.get(logical, logical[len("tel_"):]):
               window[logical] for logical, _ in self._counters}
        ticks = window.get("tel_ticks", 0)
        occ = window.get("tel_occupancy", 0)
        out["mean_live_lanes"] = (round(occ / ticks, 4)
                                  if ticks else None)
        return out

    def metric_samples(self, labels: Dict[str, str]) -> List[tuple]:
        """Pull-provider samples of the cumulative totals (``_total``
        series never reset; a window is the scraper's delta)."""
        return [(self._metric_by_logical[logical], labels,
                 self.totals[logical])
                for logical, _ in self._counters]
