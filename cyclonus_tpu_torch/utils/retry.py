"""Full-jitter exponential backoff (a copy of the reference package's
utils/retry.py).

The worker client's batch retry envelope (worker/client.py) sleeps

    base * 2^(attempt-1) * U[0.5, 1.5)

between attempts: exponential so a genuinely down backend isn't
hammered, jittered so clients racing for the same pod desynchronize
(the AWS "full jitter" result), and never after the final attempt.
"""

from __future__ import annotations

import random


def full_jitter_pause(
    base_s: float, attempt: int, rng: random.Random
) -> float:
    """Seconds to sleep after failed attempt number `attempt` (1-based)."""
    return base_s * (2 ** (attempt - 1)) * (0.5 + rng.random())
