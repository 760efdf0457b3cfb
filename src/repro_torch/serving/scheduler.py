"""Request-stream scheduling primitives for the serve engine.

``Request`` is the unit of serving work (a prompt plus a generation
budget, stamped with its arrival time); ``poisson_requests`` synthesises
the millions-of-users scenario at benchmark scale — exponential
inter-arrival gaps and heavy-tailed generation lengths, so arrivals
straddle batch boundaries and a static batch pays the max-of-batch
drain; ``SlotAllocator`` is the free-list over the fixed-capacity
slot-major ``DecodeCache``.

A copy of ``repro/serving/scheduler.py`` (numpy only), so that the port
never imports the JAX package: the same seed gives the same stream.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, List

import numpy as np

__all__ = ["Request", "poisson_requests", "SlotAllocator"]


@dataclasses.dataclass
class Request:
    """One serving request.

    ``tokens`` is the (P,) int32 prompt; ``max_new_tokens`` the greedy
    generation budget (0 = the engine plan's default).  ``arrival_ms``
    is on the engine's virtual clock — wall-clock ms when the stream is
    replayed against a ``MeasuredTimer``, cost-model ms under ``ModelTimer``.
    """
    id: int
    arrival_ms: float
    tokens: Any
    max_new_tokens: int = 0


def poisson_requests(n: int, rate_rps: float, *, seed: int = 0,
                     prompt_lens=(8, 12, 16, 24),
                     gen_lens=(4, 8, 16, 48),
                     gen_probs=(0.35, 0.30, 0.25, 0.10),
                     vocab_size: int = 128) -> List[Request]:
    """A Poisson-arrival request stream: exponential gaps at ``rate_rps``
    requests/second, uniform prompt lengths, heavy-tailed generation
    lengths (most requests are short; a 48-token tail makes static
    batching drain at the max of each batch).
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1000.0 / rate_rps, size=n)          # ms
    arrivals = np.cumsum(gaps)
    reqs = []
    for i in range(n):
        p = int(rng.choice(np.asarray(prompt_lens)))
        g = int(rng.choice(np.asarray(gen_lens), p=np.asarray(gen_probs)))
        toks = rng.integers(0, vocab_size, size=(p,), dtype=np.int32)
        reqs.append(Request(id=i, arrival_ms=float(arrivals[i]),
                            tokens=toks, max_new_tokens=g))
    return reqs


class SlotAllocator:
    """Free-list over ``n`` cache slots.  Always hands out the lowest
    free slot so runs are deterministic and evicted slots are provably
    reused (the test_serve invariant)."""

    def __init__(self, n: int):
        self.capacity = n
        self._free = list(range(n))
        heapq.heapify(self._free)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("no free cache slot (capacity "
                               f"{self.capacity}); evict first")
        return heapq.heappop(self._free)

    def free(self, slot: int) -> None:
        if slot in self._free or not 0 <= slot < self.capacity:
            raise ValueError(f"bad free of slot {slot}")
        heapq.heappush(self._free, slot)
