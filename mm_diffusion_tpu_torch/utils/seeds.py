"""Seeds derived from a key of integers."""

from __future__ import annotations

import numpy as np


def derive_seed(*key: int) -> int:
    """A 63-bit seed for ``key`` (a run's seed, a step, a stream, a rank...).
    numpy's ``SeedSequence`` hashes the whole key, so two different keys
    give unrelated seeds; sums of offsets, by contrast, meet (seed + step +
    k * rank at one step is another rank's seed at a later step)."""
    state = np.random.SeedSequence([k % 2**64 for k in key]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))
