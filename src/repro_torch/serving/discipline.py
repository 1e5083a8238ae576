"""Rotating round-robin head selection — the one admission discipline.

The paper's per-user FIFO rule (§4) is enforced at two layers: the serving
``Scheduler`` refilling decode slots and the proxy ``AdmissionController``
forming cross-user batches.  Both pick the next user the same way, so the
selection logic lives here, once:

* heads carrying a deadline are served earliest-*effective*-deadline-first
  (absolute deadline plus ``tier * tier_penalty`` of budget-depletion
  slack), rotation order breaking ties;
* deadline-free heads go lowest-tier-first in rotation order (plain
  rotation when every head is equally funded).

Callers supply ``eligible`` as ``(rotation_offset, user)`` pairs — offsets
relative to their rotating scan start — plus accessors for the head's
absolute deadline and effective tier.  Dependency-free on purpose: the
proxy layer imports it without pulling the serving stack.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple


def select_rotating_head(
        eligible: List[Tuple[int, str]],
        deadline_of: Callable[[str], Optional[float]],
        tier_of: Optional[Callable[[str], int]] = None,
        tier_penalty: float = 0.0) -> Tuple[int, str]:
    """Pick the next ``(rotation_offset, user)`` from non-empty ``eligible``."""
    tier_of = tier_of or (lambda user: 0)
    deadlined = [t for t in eligible if deadline_of(t[1]) is not None]
    if deadlined:
        return min(deadlined, key=lambda t: (
            deadline_of(t[1]) + tier_of(t[1]) * tier_penalty, t[0]))
    return min(eligible, key=lambda t: (tier_of(t[1]), t[0]))
