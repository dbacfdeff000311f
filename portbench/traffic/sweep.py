"""Traffic kind "sweep": the missing-ratio sweep of a test split.

The mix (traffic/<mix>.json) gives the split's rows, the batch, the missing
types and ratios, the classes and the token lengths. The configuration's
model family (harness.family) gives the weights, the port's model config,
the inputs and the plain reference. Set-up draws the weights and the split
from the seed, keeps the split in host memory and runs one (type, ratio)
point as warm-up. The window drives the port's
`run_missing_sweep` with `make_eval_step`'s step one point at a time, in
order and wrapping around, a closed loop: every batch is uploaded, run and
read back before the next. It counts the real rows of every point completed.

The check, once the window has closed:
- metric_err: the largest gap between the accuracy, macro-F1 and AUC that the
  port's sweep reported for a point and those that the harness computes from
  the port's own predictions and probabilities of that point's real rows;
- logit_err: on a sample of the window's batches drawn from the seed, the
  largest gap between the port's log-probabilities and the plain reference's
  (float32), each row's gaps taken about their mean over the classes, since
  log-probabilities are logits up to a constant a row;
- pred_gap: on the same rows, the widest gap by which the reference's
  log-probability of the port's predicted class lies below its best.
A cell compares the numbers its limits (workloads/<cell>.json) name.
"""
from __future__ import annotations

import os
import random
import tempfile
import time

import numpy as np
import torch

from .. import inputs
from ..checks import Check, metrics as harness_metrics
from ..harness import family


class Loader:
    """One (type, ratio) point's loader: the split in batches of
    `batch_size` rows, the last one shorter, as the port's loaders yield
    them ((data, labels, codes))."""

    def __init__(self, data, labels, codes, batch_size):
        self.data, self.labels, self.codes = data, labels, codes
        self.batch_size = batch_size

    def __iter__(self):
        for i in range(0, len(self.labels), self.batch_size):
            sl = slice(i, i + self.batch_size)
            yield inputs.rows(self.data, sl), self.labels[sl], self.codes[sl]


class Runner:
    kind = "sweep"

    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.ref = family(cfg, "reference")
        self.batch = mix["batch"]
        self.n = mix["rows"]
        real = [m for m in cfg["modality_types"]]
        types = mix["missing_types"]
        self.points = [(t, r) for t in types for r in mix["ratios"]]
        self.codes = {(t, r): inputs.missing_codes(
            self.n, t, r, real, seed * 16 + types.index(t))
            for t, r in self.points}
        self.record = False
        self.outs = []          # (call, point, batch index, out) of the window
        self.results = []       # (call, point, metrics the port reported)
        self.next_point = 0     # calls of run_missing_sweep so far

    # -- set-up ------------------------------------------------------------

    def setup(self):
        from missm_tpu_torch.eval.sweep import run_missing_sweep
        from missm_tpu_torch.train.step import make_eval_step

        from .. import port

        dev, model = self.device, family(self.cfg, "port")
        if dev.type == "cuda":
            port.build_kernels(self.mix["kernels"])
        self.params = self.ref.make_params(self.cfg, self.seed, dev)
        self.model_cfg = model.model_config(self.cfg)
        step = make_eval_step(self.model_cfg, device=dev)
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.data = {"language": model.text(self.cfg, self.n, rng,
                                            self.mix["text_lengths"])}
        self.data.update(model.media(self.cfg, self.n, gen))
        self.labels = inputs.labels(self.n, self.cfg["fusion"]["output_dims"],
                                    rng)
        self.out_dir = os.path.join(tempfile.gettempdir(), "portbench-sweep")
        self._sweep = run_missing_sweep

        def recording_step(params, data, labels, missing, valid=None):
            out = step(params, data, labels, missing, valid=valid)
            if self.record:
                self.outs.append((self.next_point, self._point, self._batch,
                                  out))
            self._batch += 1
            return out

        self.step = recording_step
        self._run_point(self.points[0])          # warm-up: every shape
        self.results.clear()

    def _run_point(self, point):
        t, r = point
        self._point, self._batch = point, 0
        loader = Loader(self.data, self.labels, self.codes[point], self.batch)
        res = self._sweep(self.params, self.model_cfg, self.step,
                          {t: {r: loader}}, self.out_dir,
                          self.mix["dataset"],
                          self.cfg["fusion"]["fusion_type"], verbose=False,
                          device=self.device)
        if self.record:
            self.results.append((self.next_point, point, res[t][r]))
        return self._batch

    # -- the window ----------------------------------------------------------

    def window(self, seconds, record=True):
        """Points until `seconds` have passed; (real rows, batches,
        seconds)."""
        self.record = record
        rows = batches = 0
        t0 = time.perf_counter()
        while True:
            point = self.points[self.next_point % len(self.points)]
            batches += self._run_point(point)
            self.next_point += 1
            rows += self.n
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        self.record = False
        return rows, batches, elapsed

    # -- the check -----------------------------------------------------------

    def _port_rows(self):
        """{call: (preds, probs) of every row of the call's batches} of every
        call completed in the window."""
        by_call = {}
        for call, _, j, out in self.outs:
            by_call.setdefault(call, []).append((j, out))
        done = {}
        for call, _, _ in self.results:
            parts = sorted(by_call[call], key=lambda jo: jo[0])
            preds = torch.cat([o["preds"] for _, o in parts]).cpu().numpy()
            probs = torch.cat([o["probs"].float() for _, o in parts])
            done[call] = (preds, probs.cpu().numpy())
        return done

    def check(self, limits):
        done = self._port_rows()
        metric_err = 0.0
        for call, _, reported in self.results:
            preds, probs = done[call]
            # padding sits only at the end of the last batch
            ours = harness_metrics(self.labels, preds[:self.n],
                                   probs[:self.n])
            for k, v in ours.items():
                metric_err = max(metric_err, abs(reported[k] - v))

        model = self.ref.Model(self.cfg, "f32")
        logit_err = pred_gap = 0.0
        for lp_ref, pred, lp_port in self._sampled(model):
            logit_err = max(logit_err, centred_gap(lp_port, lp_ref))
            pred_gap = max(pred_gap, choice_gap(pred, lp_ref))
        return _named([Check("metric_err", metric_err, limits.get("metric_err")),
                       Check("logit_err", logit_err, limits.get("logit_err")),
                       Check("pred_gap", pred_gap, limits.get("pred_gap"))])

    def _sampled(self, model, control=None):
        """For a sample of the window's batches drawn from the seed, after
        freeing the port's step: (reference log-probabilities, the
        predictions compared, their log-probabilities), the latter the
        port's, or those of the reference model `control` in its place."""
        picks = random.Random(self.seed).sample(
            range(len(self.outs)), min(self.mix["check_batches"],
                                       len(self.outs)))
        sample = [self.outs[i] for i in picks]
        self.free()
        ref, b = self.ref, self.batch
        for _, point, j, out in sample:
            sl = slice(j * b, min((j + 1) * b, self.n))
            n = sl.stop - sl.start
            data = ref.to_device(inputs.rows(self.data, sl), self.device)
            codes = torch.as_tensor(self.codes[point][sl], device=self.device)

            def logp(m):
                return torch.log_softmax(ref.eval_logits(
                    m, self.params, data, codes,
                    self.mix["reference_rows"]).double(), dim=-1)

            lp_ref = logp(model)
            if control is None:
                lp = torch.log(out["probs"][:n].double().to(self.device))
                pred = out["preds"][:n]
            else:
                lp = logp(control)
                pred = lp.argmax(dim=-1)
            yield lp_ref, pred, lp

    def control(self, limits):
        """The check's numbers with the reference at float8 in the port's
        place (no metric_err: the control runs no sweep)."""
        model = self.ref.Model(self.cfg, "f32")
        low = self.ref.Model(self.cfg, "fp8")
        logit_err = pred_gap = 0.0
        for lp_ref, pred, lp in self._sampled(model, control=low):
            logit_err = max(logit_err, centred_gap(lp, lp_ref))
            pred_gap = max(pred_gap, choice_gap(pred, lp_ref))
        return _named([Check("logit_err", logit_err, limits.get("logit_err")),
                       Check("pred_gap", pred_gap, limits.get("pred_gap"))])

    def free(self):
        """Drop the port's step; the params and inputs are the harness's and
        stay for the reference."""
        self.step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _named(checks):
    """The numbers the cell's limits name (a cell compares what separates
    its sound runs from its control: PERF.md)."""
    return [c for c in checks if c.limit is not None]


def centred_gap(lp_a, lp_b) -> float:
    """The largest |d - mean(d)| over rows and classes, d = lp_a - lp_b
    a row."""
    d = lp_a - lp_b
    return float((d - d.mean(dim=-1, keepdim=True)).abs().max())


def choice_gap(pred, lp_ref) -> float:
    """The widest gap by which the reference's log-probability of the chosen
    class lies below the reference's best."""
    chosen = lp_ref.gather(-1, pred.long().to(lp_ref.device)[:, None])[:, 0]
    return float((lp_ref.max(dim=-1).values - chosen).max())
