"""The card's memory walk: the job allocates and frees a block on a
schedule drawn from the seed, so that every answer the program gives has
to follow the card.

A walk is a cycle of phases ``(seconds held, bytes of the block held)``:
no block, then a block, then none again, and so on, each change one
allocation or one release, so that the card's used memory moves in one
step from one phase's value to the next. Every seed holds the same set of
block sizes for the same set of times, in another order: the work of a
run does not move with the seed. The job on the card (``card.py``) walks
it; a rehearsal's simulated card (``rehearsal.py``) and the reference's
simulated reads (``reference/nvml.py``) follow it by the wall clock.
"""

from __future__ import annotations

import random

MIB = 1 << 20


def walk(seed: int, moves: dict) -> list[tuple[float, int]]:
    """One cycle of phases for a configuration's ``moves``: ``blocks``
    sizes, ``block_mib`` apart, each held once between two phases without
    a block, every phase held for one of an even spread of times over
    ``hold_s``."""
    rng = random.Random(f"moves-{seed}")
    sizes = [k * moves["block_mib"] * MIB for k in range(1, moves["blocks"] + 1)]
    rng.shuffle(sizes)
    lo, hi = moves["hold_s"]
    n = 2 * len(sizes)
    holds = [lo + (hi - lo) * i / (n - 1) for i in range(n)]
    rng.shuffle(holds)
    phases = []
    for i, size in enumerate(sizes):
        phases += [(holds[2 * i], 0), (holds[2 * i + 1], size)]
    return phases


def block_at(phases: list[tuple[float, int]], elapsed: float) -> int:
    """The bytes of the block held ``elapsed`` seconds into the walk."""
    cycle = sum(h for h, _ in phases)
    t = elapsed % cycle if elapsed > 0 else 0.0
    for hold, size in phases:
        if t < hold:
            return size
        t -= hold
    return phases[-1][1]
