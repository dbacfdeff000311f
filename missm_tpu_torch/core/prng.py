"""PRNG discipline, after missm_tpu/core/prng.py.

The reference relies on global torch / numpy seeds (train_ddp.py:50-54).
The JAX package derives every key from one root seed; here `PRNGSeq`
derives every `torch.Generator` from one root seed the same way, so a
run's randomness is reproducible by construction. The bits differ from
JAX's: only the discipline carries over.
"""
from __future__ import annotations

import torch

from .device import resolve_device

_SEED_HIGH = 2 ** 62


def _split(key: int, n: int) -> list:
    """n + 1 seeds drawn from `key`: the next root, then n subseeds. The
    draws come in order from one generator seeded with `key`, so the next
    root is the same whatever n is."""
    g = torch.Generator().manual_seed(key)
    return torch.randint(0, _SEED_HIGH, (n + 1,), generator=g).tolist()


class PRNGSeq:
    """Hands out fresh, independent generators on `device` (the card unless
    the caller asks for the CPU), each seeded from the root; `next()` and
    `split(n)` both advance the root once. `seed_or_generator`: an int
    seed, or a torch.Generator to draw the root seed from."""

    def __init__(self, seed_or_generator, *, device="cuda"):
        self.device = resolve_device(device)
        if isinstance(seed_or_generator, torch.Generator):
            self._key = int(torch.randint(
                0, _SEED_HIGH, (1,), generator=seed_or_generator,
                device=seed_or_generator.device))
        else:
            self._key = int(seed_or_generator)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def next(self) -> torch.Generator:
        self._key, sub = _split(self._key, 1)
        return self._generator(sub)

    def split(self, n: int) -> list:
        self._key, *subs = _split(self._key, n)
        return [self._generator(s) for s in subs]
