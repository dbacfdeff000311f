"""Faults planted underneath the timed path, for the tests and the readings
that set the limits (calibrate.py). The benchmark's own runs never load
this module.

Each fault is a context manager that swaps one of the port's step makers
for a broken one while a Runner sets up:
- "answer": the eval step's answer for the first row of every batch is
  altered where it is produced (its probabilities rotated over the
  classes, its prediction with them);
- "half_eval": the eval step computes the first half of the batch and hands
  the second half the first half's answers;
- "half_train": the train step takes the first half of the batch, its mean
  over those rows alone;
- "unchanged": the train step leaves the parameters as they were (it runs
  with a learning rate of 0).
"""
from __future__ import annotations

import contextlib

SWEEP_FAULTS = ("answer", "half_eval")
TRAIN_FAULTS = ("half_train", "unchanged")


def _rows(tree, sl):
    if isinstance(tree, dict):
        return {k: _rows(v, sl) for k, v in tree.items()}
    return tree[sl]


def _broken_eval(make, fault):
    def maker(cfg, **kw):
        step = make(cfg, **kw)

        def broken(params, data, labels, missing, valid=None):
            out = dict(step(params, data, labels, missing, valid=valid))
            probs, preds = out["probs"].clone(), out["preds"].clone()
            if fault == "answer":
                probs[0] = probs[0].roll(1)
            else:
                h = (len(probs) + 1) // 2
                probs[h:] = probs[:len(probs) - h]
            preds = probs.argmax(dim=-1)
            out.update(probs=probs, preds=preds)
            return out
        return broken
    return maker


def _broken_train(make, fault):
    def maker(cfg, tx, accum_steps=1, **kw):
        step = make(cfg, tx, accum_steps, **kw)

        def broken(state, data, labels, missing, lr, generator, valid=None):
            if fault == "unchanged":
                return step(state, data, labels, missing, 0.0, generator, valid)
            h = len(labels) // 2
            return step(state, _rows(data, slice(0, h)), labels[:h],
                        missing[:h], lr, generator)
        return broken
    return maker


@contextlib.contextmanager
def planted(fault: str):
    """The port's step maker for `fault` broken while the block runs."""
    from missm_tpu_torch.train import step as module
    name = "make_eval_step" if fault in SWEEP_FAULTS else "make_train_step"
    real = getattr(module, name)
    wrap = _broken_eval if fault in SWEEP_FAULTS else _broken_train
    setattr(module, name, wrap(real, fault))
    try:
        yield
    finally:
        setattr(module, name, real)
