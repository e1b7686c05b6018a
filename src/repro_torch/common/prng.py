"""Deterministic generator sequencing (twin of ``repro/common/prng.py``).

``jax.random.split`` derives keys by Threefry, which torch cannot replay, so
the port's streams agree with JAX's in shape and distribution, not in bits.
"""
from __future__ import annotations

import torch

from repro_torch.common.device import resolve_device


class PRNGSeq:
    """An iterator of fresh ``torch.Generator``s on ``device``, each seeded
    from a draw of one parent generator.

    Keeps init code linear: ``gens = PRNGSeq(0, device); w = init(next(gens))``.
    The same seed (or a generator in the same state) gives the same sequence.
    """

    def __init__(self, seed_or_generator: int | torch.Generator, device="cuda"):
        self.device = resolve_device(device)
        if isinstance(seed_or_generator, int):
            self._parent = torch.Generator().manual_seed(seed_or_generator)
        else:
            self._parent = seed_or_generator

    def _seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (), generator=self._parent,
                                 device=self._parent.device))

    def __next__(self) -> torch.Generator:
        # a meta tensor draws nothing: its generators live on the host
        dev = "cpu" if self.device.type == "meta" else self.device
        return torch.Generator(dev).manual_seed(self._seed())

    def __iter__(self):
        return self

    def take(self, n: int) -> list[torch.Generator]:
        return [next(self) for _ in range(n)]
