"""ReduceLROnPlateau, host-side state machine (copy of
missm_tpu/train/plateau.py).

torch.optim.lr_scheduler.ReduceLROnPlateau semantics with the reference's
arguments (train_ddp.py:206): mode='max', factor=0.1, patience=3,
threshold=1e-4 (relative), cooldown=0, min_lr=0. The train loop multiplies
the learning rate by the resulting scale at every step."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PlateauState:
    best: float
    num_bad_epochs: int
    scale: float


def plateau_init() -> PlateauState:
    return PlateauState(best=float("-inf"), num_bad_epochs=0, scale=1.0)


def plateau_update(state: PlateauState, metric: float, *,
                   factor: float = 0.1, patience: int = 3,
                   threshold: float = 1e-4) -> PlateauState:
    """mode='max', threshold_mode='rel': better iff
    metric > best * (1 + threshold) (torch uses best + |best|*threshold for
    negative best; metrics here are accuracies >= 0)."""
    if metric > state.best * (1.0 + threshold) or state.best == float("-inf"):
        return PlateauState(best=metric, num_bad_epochs=0, scale=state.scale)
    bad = state.num_bad_epochs + 1
    if bad > patience:
        return PlateauState(best=state.best, num_bad_epochs=0,
                            scale=state.scale * factor)
    return PlateauState(best=state.best, num_bad_epochs=bad,
                        scale=state.scale)
