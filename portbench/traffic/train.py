"""Traffic kind "train": LoRA fine-tuning, one Adam step per batch.

The mix (traffic/<mix>.json) gives the batch, the pool of batches, the
missing codes drawn per row, the learning rate and the token lengths. The
configuration's model family (harness.family) gives the weights and their
layout, the port's model config, the inputs and the plain reference.
Set-up draws the weights and a pool of distinct batches from the seed (host
memory, the loaders' layout), builds the port's train state
(`init_train_state`'s Adam) and step (`make_train_step`, one pass a step),
and drives that same state through its first three steps on pool batches
0-2. Those steps are the warm-up and the ones the check follows. The window
goes on from batch 3, cycling the pool, a closed loop: each step's loss is
read back before the next step starts.

The check, once the window has closed, against the plain reference's three
Adam steps (float32) from the same weights, batches and dropout masks:
- loss_err: the largest relative gap of a step's loss;
- grad_err: the first gradient as the port's Adam got it (its first moment
  after step 1 over 1 - beta1) against the reference's, leaf by leaf: the
  norm of the difference against the larger of the leaf's reference norm
  and the median leaf's (checks.leaf_gaps), at the median leaf. A gap of
  norms is second order in rounding noise and reads float8 as bfloat16;
  the worst leaf is a tower's logit scale, a scalar summed with deep
  cancellation that bfloat16 alone moves by up to its whole size
  (PERF.md);
- change_err: the change of the trainable leaves over the three steps, the
  gap of each leaf's norm from the reference's, by the worst leaf;
both leave out the leaves whose reference gradient is under a thousandth of
the median leaf's (they move by round-off alone, or not at all);
- frozen_err: the largest change of a frozen leaf over set-up and window.
A cell compares the numbers its limits (workloads/<cell>.json) name.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs
from ..checks import Check, leaf_gaps
from ..harness import family

CHECKED_STEPS = 3
BETA1 = 0.9


class Runner:
    kind = "train"

    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.ref = family(cfg, "reference")
        self.batch = mix["batch"]
        self.lr = mix["learning_rate"]
        self.next = 0

    def setup(self):
        from missm_tpu_torch.train.step import init_train_state, make_train_step

        from .. import port

        dev, model, ref = self.device, family(self.cfg, "port"), self.ref
        if dev.type == "cuda":
            port.build_kernels(self.mix["kernels"])
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        B, pool = self.batch, self.mix["pool"]
        data = {"language": model.text(self.cfg, B * pool, rng,
                                       self.mix["text_lengths"])}
        data.update(model.media(self.cfg, B * pool, gen))
        labels = inputs.labels(B * pool, self.cfg["fusion"]["output_dims"], rng)
        codes = inputs.train_codes(B * pool, self.mix["codes"], rng)
        self.pool = [(inputs.rows(data, slice(i * B, (i + 1) * B)),
                      labels[i * B:(i + 1) * B], codes[i * B:(i + 1) * B])
                     for i in range(pool)]

        self.params = ref.make_params(self.cfg, self.seed, dev)
        self.named = ref.paths_of(self.params)
        self.paths = [path for path, _ in self.named if ref.trainable(path)]
        cfg = model.model_config(self.cfg)
        self.state, self.tx = init_train_state(self.params, cfg)
        self.step_fn = make_train_step(cfg, self.tx, accum_steps=1, device=dev)
        # the head's dropout draws; the reference draws the same masks
        self.drop_seed = self.seed + 1
        self.gen = torch.Generator(device=dev).manual_seed(self.drop_seed)

        train = [leaf for path, leaf in self.named if ref.trainable(path)]
        start = [leaf.detach().clone() for leaf in train]
        self.losses = [self._step() for _ in range(CHECKED_STEPS)]
        self.change = [float((leaf.detach() - s).norm())
                       for leaf, s in zip(train, start)]
        del start

    def _step(self):
        data, labels, codes = self.pool[self.next % len(self.pool)]
        self.next += 1
        self.state, out = self.step_fn(self.state, data, labels, codes,
                                       self.lr, self.gen)
        loss = float(out["loss"])
        if self.next == 1:
            # the first moment after one step is (1 - beta1) g
            exp_avg = [self.tx.state.get(leaf, {}).get("exp_avg")
                       for path, leaf in self.named
                       if self.ref.trainable(path)]
            # kept in host memory until the check
            self.first_grad = [None if m is None else
                               (m / (1 - BETA1)).to("cpu") for m in exp_avg]
        return loss

    def window(self, seconds, record=True):
        """Steps until `seconds` have passed; (samples, steps, seconds)."""
        steps = 0
        t0 = time.perf_counter()
        while True:
            self._step()
            steps += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return steps * self.batch, steps, elapsed

    def check(self, limits):
        dev, ref = self.device, self.ref
        start = ref.make_params(self.cfg, self.seed, dev)
        frozen_err = 0.0
        for (path, leaf), (_, s) in zip(self.named, ref.paths_of(start)):
            if not ref.trainable(path):
                frozen_err = max(frozen_err, float(
                    (leaf.detach().float() - s).abs().max()))
        self.free()

        losses, first, change = self._reference(start, "f32")
        return self.compare(losses, first, change, limits, frozen_err)

    def _reference(self, start, precision):
        """The reference's three steps from `start` (updated in place) at
        `precision`: (losses, first gradients, change norms)."""
        ref = self.ref
        train0 = [leaf.clone() for path, leaf in ref.paths_of(start)
                  if ref.trainable(path)]
        losses, first, after = ref.train_steps(
            ref.Model(self.cfg, precision), start, self._reference_batches(),
            self.lr, self.mix["reference_rows"])
        return losses, first, [float((a - s).norm())
                               for a, s in zip(after.values(), train0)]

    def control(self, limits):
        """The check's numbers with the reference at float8 in the port's
        place, against the float32 reference (no frozen_err: the reference
        has no frozen copy to keep)."""
        self.free()
        dev, make = self.device, self.ref.make_params
        self.losses, first, self.change = self._reference(
            make(self.cfg, self.seed, dev), "fp8")
        self.first_grad = [g.cpu() for g in first]
        del first
        losses, first, change = self._reference(
            make(self.cfg, self.seed, dev), "f32")
        return [c for c in self.compare(losses, first, change, limits, 0.0)
                if c.name != "frozen_err"]

    def _reference_batches(self):
        dev, fd = self.device, self.cfg["fusion"]["fusion_dim"]
        keep = 1.0 - self.cfg["fusion"]["dropout_prob"]
        masks = self.ref.seeded_dropout(self.drop_seed, (self.batch, fd),
                                        keep, dev)
        out = []
        for data, labels, codes in self.pool[:CHECKED_STEPS]:
            out.append((self.ref.to_device(data, dev),
                        torch.as_tensor(labels, device=dev),
                        torch.as_tensor(codes, device=dev), next(masks)))
        return out

    def compare(self, losses, first, change, limits, frozen_err):
        """The numbers `limits` names, from the reference's losses, first
        gradients (tensors on the device) and change norms."""
        loss_err = max(abs(p - r) / abs(r) for p, r in zip(self.losses, losses))
        norms = [float(g.norm()) for g in first]
        med = float(np.median(norms))
        moving = [n >= 1e-3 * med for n in norms]
        diff = [float(((p.to(r.device) if p is not None else 0) - r).norm())
                for p, r in zip(self.first_grad, first)]
        grads = leaf_gaps(diff, norms, moving)
        changes = leaf_gaps([abs(p - r) for p, r in zip(self.change, change)],
                            change, moving)

        def note(gaps):
            worst, i = gaps[-1]
            return (f"median leaf {gaps[len(gaps) // 2][0]!r}, worst leaf "
                    f"{'/'.join(map(str, self.paths[i]))} {worst!r}")

        checks = [Check("loss_err", loss_err, limits.get("loss_err"),
                        f"port {self.losses} reference {losses}"),
                  Check("grad_err", grads[len(grads) // 2][0],
                        limits.get("grad_err"), note(grads)),
                  Check("change_err", changes[-1][0], limits.get("change_err"),
                        note(changes)),
                  Check("frozen_err", frozen_err, limits.get("frozen_err"))]
        return [c for c in checks if c.limit is not None]

    def free(self):
        """Drop the port's train state, its step and the params it updated."""
        self.state = self.tx = self.step_fn = self.params = None
        self.named = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
