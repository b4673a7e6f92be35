"""Admission-capacity feasibility of chat sessions: the port's copy of
``CapacityCheck`` and ``session_feasibility`` from
``paddle_tpu/analysis/liveness.py`` (lines 71-117 there), the part the
paged server calls. The JAX package's checker ledger, release
obligations and While-variant proofs are not carried over.

A chat session pins one ``PromptPrefixCache`` entry for each distinct
prompt for its whole lifetime. With sessions that never close, the
steady-state demand is the count of distinct session prompts (one more
when sessionless traffic shares the cache), and admission waits forever
once demand exceeds the entry pool: every entry is pinned, so no
eviction can help.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["CapacityCheck", "session_feasibility"]


@dataclass(frozen=True)
class CapacityCheck:
    """One resource pool's verdict: worst-case steady-state ``demand``
    against static ``supply``, with a ``witness`` sentence when
    infeasible."""

    resource: str
    demand: int
    supply: int
    feasible: bool
    witness: Optional[str] = None

    def describe(self) -> str:
        if self.feasible:
            return (f"{self.resource}: demand {self.demand} <= supply "
                    f"{self.supply} [feasible]")
        return (f"{self.resource}: demand {self.demand} > supply "
                f"{self.supply} [INFEASIBLE]")


def session_feasibility(n_prompt_entries: int, distinct_prompts: int,
                        sessions_close: bool = False,
                        cold_traffic: bool = False) -> CapacityCheck:
    """The session-pinning predicate: feasible when sessions close, or
    when the distinct session prompts (plus one churn entry with
    ``cold_traffic``) fit the entry pool."""
    demand = int(distinct_prompts) + (1 if cold_traffic else 0)
    supply = int(n_prompt_entries)
    feasible = bool(sessions_close) or demand <= supply
    witness = None
    if not feasible:
        witness = (
            f"session-pinning admission deadlock: {distinct_prompts} "
            f"distinct session prompts"
            + (" + 1 churn entry for non-session traffic"
               if cold_traffic else "")
            + f" each pin a PromptPrefixCache entry for the session "
              f"lifetime, but n_prompt_entries={n_prompt_entries}; "
              f"once {n_prompt_entries} sessions are admitted every "
              f"entry is pinned (refcount>0, unevictable) and every "
              f"later admission waits forever")
    return CapacityCheck("PromptPrefixCache", demand, supply, feasible,
                         witness)
