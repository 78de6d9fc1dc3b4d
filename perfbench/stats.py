"""Order statistics of the benchmark's timings."""
from __future__ import annotations

import random


def percentile(values, p: float) -> float:
    """The value at rank int(p * n) of the sorted values (the arithmetic of
    tpu_collide_torch/bench/harness.py's _percentile, copied)."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no values")
    return s[min(len(s) - 1, int(p * len(s)))]


class Reservoir:
    """A uniform sample of at most `size` of the indices offered, drawn from
    `seed` (Algorithm R). `offer()` says before the next item runs whether
    it is kept, so that a caller holds on to the items it keeps and to no
    other."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self._rng = random.Random(seed)
        self.items: dict[int, object] = {}
        self._slot: dict[int, int] = {}
        self._seen = 0

    def offer(self) -> int | None:
        """The slot the next item goes into, or None if it is not kept."""
        i = self._seen
        self._seen += 1
        if i < self.size:
            return i
        j = self._rng.randint(0, i)
        return j if j < self.size else None

    def put(self, slot: int, index: int, item) -> None:
        old = self._slot.pop(slot, None)
        if old is not None:
            self.items.pop(old, None)
        self._slot[slot] = index
        self.items[index] = item

    def sample(self) -> list:
        """[(index, item)] in the order the items ran."""
        return sorted(self.items.items(), key=lambda kv: kv[0])
