"""The training loop, after missm_tpu/train/loop.py: the host-side epoch
loop of `train()` (reference train_ddp.py:138-329) around the port's train
and eval steps:

- per epoch: train steps over the train loader, then an eval pass on the
  valid loader;
- ReduceLROnPlateau on val accuracy (factor .1, patience 3);
- best-checkpoint save on val-accuracy improvement + early stop patience;
- final reload of the best params and standalone final-model save;
- TensorBoard scalars (Loss/train + {loss,accuracy,f1,auc}/val);
- resume checkpoints every N epochs and on SIGTERM.

Across processes (cfg.parallel, a parallel.partitioning.Layout, with the
params and the teacher this rank's): each data rank's loaders are its
shards, the validation pass gathers over the data group, checkpoints
gather the shards into the full tree that rank 0 writes (and a resume
re-shards it), rank 0 alone prints, and a SIGTERM on any rank stops every
rank at the same batch (`_agreed_stop`) before the collective resume
save.
"""
from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..eval.sweep import _pad_batch, data_group, evaluate_metrics
from ..models.finetune import ModelConfig, tree_map
from ..utils.prefetch import prefetch
from ..utils.profiling import start_profiler, stop_profiler
from .checkpoint import AsyncSaver, read_metadata, restore_checkpoint, \
    save_checkpoint
from .plateau import PlateauState, plateau_init, plateau_update
from .step import TrainState, init_train_state, make_eval_step, \
    make_train_step


class PreemptedError(RuntimeError):
    """Raised by train_loop once a SIGTERM-triggered resume checkpoint
    has landed on disk. Rerun the same command (with --resume auto) to
    continue; cli/train.py converts this into exit code 75 (EX_TEMPFAIL)
    so schedulers treat the run as retriable, not failed."""


class _PreemptionGuard:
    """SIGTERM -> cooperative stop flag for the epoch loop.

    The first signal only sets `triggered` (the loop checks it at batch
    boundaries, lands checkpoints, exits cleanly) and immediately
    restores the previous handler, so a second SIGTERM from an escalating
    scheduler keeps its normal fatal meaning. Installs nothing when not in
    the main thread (signal.signal would raise): train_loop then has no
    preemption handling."""

    def __init__(self, log: Callable = print):
        self.triggered = False
        self._log = log
        self._logged = False
        self._prev = None
        self._mine = None

    def _restorable_prev(self):
        # getsignal/signal return None for a handler installed by
        # non-Python code, which signal.signal does not take back
        import signal
        return self._prev if self._prev is not None else signal.SIG_DFL

    def check(self) -> bool:
        """`triggered`, plus first-observation logging. The handler itself
        stays async-signal-safe: a print from handler context can hit
        'reentrant call inside BufferedWriter' when the signal interrupts a
        main-thread print, and the RuntimeError would unwind train_loop
        past the checkpoint it was about to write, so the message is
        logged here, at the loop's next boundary."""
        if self.triggered and not self._logged:
            self._logged = True
            self._log("SIGTERM: stopping at this batch boundary, writing "
                      "the resume checkpoint, then exiting cleanly (a "
                      "second SIGTERM kills immediately)")
        return self.triggered

    def __enter__(self):
        import signal
        import threading
        if threading.current_thread() is not threading.main_thread():
            return self

        def handler(signum, frame):
            # flag + handler restore only: both async-signal-safe
            self.triggered = True
            signal.signal(signal.SIGTERM, self._restorable_prev())

        self._mine = handler
        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def __exit__(self, *exc):
        import signal
        if (self._mine is not None
                and signal.getsignal(signal.SIGTERM) is self._mine):
            signal.signal(signal.SIGTERM, self._restorable_prev())
        return False


def _full(tree, lay, part=None):
    """The full tree of this rank's `tree` (a collective under a layout);
    `part` names the subtree of the specs it is ("fusion" for the
    teacher)."""
    if lay is None or tree is None:
        return tree
    if part is None:
        return lay.gather(tree)
    return lay.gather({part: tree})[part]


def _opt_tree(params, tx, lay):
    """Adam's state as trees shaped like the full params (None where a leaf
    has none): its moments gathered like their leaves, so a checkpoint
    written by n ranks restores on any layout."""
    step = [0.0]

    def moment(key):
        def get(p):
            st = tx.state.get(p)
            if not st:
                return None
            step[0] = float(st["step"])
            return st[key]
        return tree_map(get, params)

    out = {k: lay.gather(moment(k)) for k in ("exp_avg", "exp_avg_sq")}
    out["step"] = step[0]
    return out


def _load_opt_tree(params, tx, lay, tree):
    """Adam's state from `_opt_tree`'s form, cut to this rank's leaves."""
    avg = lay.partition(tree["exp_avg"])
    sq = lay.partition(tree["exp_avg_sq"])
    flat_p, flat_a, flat_s = [], [], []
    tree_map(flat_p.append, params)
    tree_map(flat_a.append, avg)
    tree_map(flat_s.append, sq)
    for p, a, q in zip(flat_p, flat_a, flat_s):
        if a is None or not p.requires_grad:
            continue
        tx.state[p] = {"step": torch.tensor(float(tree["step"])),
                       "exp_avg": a.to(p.device, p.dtype).clone(),
                       "exp_avg_sq": q.to(p.device, p.dtype).clone()}


def _state_tree(state: TrainState, tx, lay=None) -> dict:
    """What a resume checkpoint holds; under a layout the full trees (a
    collective)."""
    if lay is None:
        return {"params": state.params, "opt_state": tx.state_dict(),
                "teacher_fusion": state.teacher_fusion, "step": state.step}
    return {"params": _full(state.params, lay),
            "opt_state": _opt_tree(state.params, tx, lay),
            "teacher_fusion": _full(state.teacher_fusion, lay, "fusion"),
            "step": state.step}


def _copy_into(dst, src, where="params"):
    """Every tensor of `src` copied into its twin in `dst` (dicts by key,
    lists by position), in place: the optimizer holds the param tensors,
    so a resume fills them rather than replacing them."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint {where} keys {sorted(src)} differ "
                             f"from the model's {sorted(dst)}")
        for k in dst:
            _copy_into(dst[k], src[k], f"{where}.{k}")
    elif isinstance(dst, list):
        if len(dst) != len(src):
            raise ValueError(f"checkpoint {where} has {len(src)} entries, "
                             f"the model {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, f"{where}[{i}]")
    else:
        if dst.shape != src.shape:
            raise ValueError(f"checkpoint {where} has shape "
                             f"{tuple(src.shape)}, the model "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)


def _restore_loop_state(path: str, state: TrainState, tx, lay=None):
    """Restore (TrainState, loop-state dict) from a `checkpoint_every`
    checkpoint written by train_loop, into the freshly built `state` and
    its optimizer `tx`: the params and the teacher in place (same dtypes
    and devices), the optimizer through tx.load_state_dict. `tx` must be
    built over the same trainable leaves in the same order (Adam keys its
    state by position). Under a layout the full trees are cut to this
    rank's (Layout.partition)."""
    meta = read_metadata(path)
    if not meta or "loop" not in meta:
        raise ValueError(
            f"checkpoint at {path} has no loop state — only checkpoints "
            "written by train_loop(checkpoint_every=N) are resumable")
    tree, _ = restore_checkpoint(path)
    if lay is not None:
        tree = dict(tree, params=lay.partition(tree["params"]))
        if tree.get("teacher_fusion") is not None:
            tree["teacher_fusion"] = lay.partition(
                {"fusion": tree["teacher_fusion"]})["fusion"]
    _copy_into(state.params, tree["params"])
    if state.teacher_fusion is not None:
        _copy_into(state.teacher_fusion, tree["teacher_fusion"],
                   "teacher_fusion")
    if lay is None:
        tx.load_state_dict(tree["opt_state"])
    else:
        _load_opt_tree(state.params, tx, lay, tree["opt_state"])
    state = TrainState(params=state.params, opt_state=tx.state,
                       teacher_fusion=state.teacher_fusion,
                       step=int(tree["step"]))
    return state, meta["loop"]


def _loop_meta(epoch, plateau, best_metric, best_epoch, bad_epochs,
               generator_state, history, py_random) -> dict:
    """The loop-state dict a resume needs to continue exactly. `epoch`
    is the last completed epoch (resume starts at epoch + 1).

    `generator_state` is the dropout generator's get_state() as a list of
    bytes. `py_random` is random.getstate() at the resume point: the data
    pipeline's train-missing / retrieval-substitution draws consume the
    process-global `random` stream (data/datasets.py, seeded once by
    cli/train.py); restoring only the generator would replay those draws
    from stream position 0, diverging every train_missing run from its
    uninterrupted twin. (Exactness holds for the default sequential
    decode; --num_workers > 1 interleaves draws across threads and is
    order-nondeterministic with or without a resume.)"""
    return {"epoch": epoch,
            "plateau": {"best": plateau.best,
                        "num_bad_epochs": plateau.num_bad_epochs,
                        "scale": plateau.scale},
            "best_metric": best_metric,
            "best_epoch": best_epoch,
            "bad_epochs": bad_epochs,
            "generator_state": generator_state.tolist(),
            "py_random": list(py_random),
            "history": history}


def _prepared_batches(loader, batch_size, device):
    """Two-stage input pipeline: one thread decodes, collates and pads, a
    second moves the batch to `device`, so the copy of batch k overlaps the
    decode of batch k+1 (each stage double-buffered).

    Each batch carries a boolean `valid` row mask: padding repeats the
    last real row to keep one batch shape, and the train step masks those
    rows out of the loss (the reference trains the short final batch
    unpadded; an unmasked mean would hand the repeated row most of that
    step's gradient, for the same sample every epoch since the epoch order
    is a fixed permutation)."""
    def gen():
        for data, labels, missing in loader:
            n = len(labels)
            padded = _pad_batch((data, labels, missing), batch_size)
            yield padded + (np.arange(batch_size) < n,)

    def put(batch):
        return tree_map(lambda x: torch.as_tensor(x, device=device), batch)

    return prefetch(prefetch(gen(), depth=2), depth=2, transfer=put)


def train_loop(params, cfg: ModelConfig, train_loader, valid_loader, *,
               num_epochs: int, learning_rate: float,
               weight_decay: float = 0.0, patience: int = 8,
               teacher_fusion=None, seed: int = 42,
               save_dir: Optional[str] = None,
               final_path: Optional[str] = None,
               device="cuda",
               writer=None, log: Callable = print,
               args_metadata: Optional[dict] = None,
               sync_every: int = 32, accum_steps: int = 1,
               profile_dir: Optional[str] = None,
               checkpoint_every: int = 0,
               resume_from: Optional[str] = None):
    """Returns (best_params, history). `params` must lie on `device`; the
    loop updates them in place. best_params are the params restored from
    the best checkpoint (on the CPU) when `save_dir` is given and some
    epoch improved, else the last epoch's params. `writer` is an optional
    TensorBoard SummaryWriter-compatible object.

    Dropout draws from one torch.Generator on `device`, seeded with `seed`
    and passed to every step (the JAX loop splits a key per step).

    Preemption safety (beyond the reference, which always restarts from
    scratch — SURVEY §5 checkpoint/resume): `checkpoint_every=N` writes a
    full resume checkpoint (params, the optimizer's state_dict, the
    teacher, the step, and the loop state: plateau scheduler, best/bad-
    epoch counters, the epoch-end generator state and the `random` stream
    position) to `save_dir/last` every N epochs, asynchronously;
    `resume_from` restores one and continues exactly — same dropout
    stream, same plateau decisions — as if the run had never stopped (the
    epoch order is a fixed permutation, loaders.epoch_order, so the data
    stream is position-independent).

    Graceful preemption: a SIGTERM stops the loop at the next batch
    boundary, synchronously writes the same resume checkpoint to
    `save_dir/last`, and raises PreemptedError. A mid-epoch stop keeps
    the partial epoch's updates in params and re-runs that epoch from
    its start on resume, the generator rewound to the epoch's start (its
    batches train twice, a bounded, standard preemption cost); a stop that
    lands between epochs resumes exactly.

    The epoch loss is accumulated on the device and read back once per
    `sync_every` steps plus once at epoch end, so the host queues steps
    ahead of the card instead of waiting on each step's loss."""
    dev = resolve_device(device)
    lay = cfg.parallel
    group = data_group(cfg)
    if _world() > 1 and torch.distributed.get_rank() != 0:
        log = _quiet
    state, tx = init_train_state(params, cfg, weight_decay=weight_decay,
                                 teacher_fusion=teacher_fusion)
    step_fn = make_train_step(cfg, tx, accum_steps=accum_steps, device=dev)
    eval_fn = make_eval_step(cfg, device=dev)

    plateau = plateau_init()
    saver = AsyncSaver()
    last_saver = AsyncSaver()  # separate: a best + a resume write may
    best_metric = 0.0          # both be in flight (different paths)
    best_epoch = -1
    bad_epochs = 0
    history = []
    # a data replica's ranks draw alike; replicas draw apart
    gen = torch.Generator(device=dev).manual_seed(
        seed + (lay.data_index if lay is not None else 0))
    batch_size = train_loader.batch_size
    start_epoch = 0
    if resume_from:
        state, loop_meta = _restore_loop_state(resume_from, state, tx, lay)
        start_epoch = int(loop_meta["epoch"]) + 1
        pl = loop_meta["plateau"]
        # metadata JSON stringifies non-native scalars (default=str):
        # coerce, or plateau comparisons would see strings
        plateau = PlateauState(best=float(pl["best"]),
                               num_bad_epochs=int(pl["num_bad_epochs"]),
                               scale=float(pl["scale"]))
        best_metric = float(loop_meta["best_metric"])
        best_epoch = int(loop_meta["best_epoch"])
        bad_epochs = int(loop_meta["bad_epochs"])
        history = list(loop_meta.get("history", []))
        gen.set_state(torch.tensor(loop_meta["generator_state"],
                                   dtype=torch.uint8))
        if loop_meta.get("py_random"):
            # the data pipeline's random.choice draws continue from the
            # checkpointed stream position (see _loop_meta)
            st = loop_meta["py_random"]
            random.setstate((int(st[0]), tuple(int(v) for v in st[1]),
                             None if st[2] is None else float(st[2])))
        log(f"Resumed from {resume_from}: continuing at epoch "
            f"{start_epoch + 1} (best={best_metric:.4f} @ epoch "
            f"{best_epoch + 1}, lr_scale={plateau.scale:g})")

    step_dev_s = None  # calibrated step time (min over epochs)
    profiler = None    # profile_dir: trace epoch-0 batches 4-6
    preempted = False
    preempt_partial = 0
    gen_epoch_start = gen.get_state()
    py_rand_start = random.getstate()
    with _PreemptionGuard(log=log) as preempt:
        for epoch in range(start_epoch, num_epochs):
            # the resume point if this epoch re-runs (the generator + the
            # python stream the datasets' missing-code draws consume)
            gen_epoch_start = gen.get_state()
            py_rand_start = random.getstate()
            if _agreed_stop(preempt.check(), dev):
                # signal landed during the previous epoch's eval/saves: that
                # epoch completed fully, so the resume is exact
                preempted = True
                break
            t0 = time.time()
            loss_acc = None  # device-resident running sum
            n_batches = 0
            input_s = 0.0
            step_s = 0.0
            stop_mid = False
            t_in = time.perf_counter()
            for data, labels, missing, valid in _prepared_batches(
                    train_loader, batch_size, dev):
                t_now = time.perf_counter()
                input_s += t_now - t_in
                lr = learning_rate * plateau.scale
                state, m = step_fn(state, data, labels, missing, lr, gen,
                                   valid=valid)
                loss_acc = m["loss"] if loss_acc is None else loss_acc + m["loss"]
                n_batches += 1
                if n_batches in (2, 3):
                    # calibrate the step: drain after batch 2 (flushing the
                    # warm-up and the backlog), then time batch 3 from its
                    # start on the idle device to its drain: the host's
                    # launches and the device's work of one step, no input
                    # wait. Launches are asynchronous, so wall-clock alone
                    # cannot separate waiting on input from the step; the
                    # duty meter below uses n * this against the epoch
                    # wall. Re-calibrated every epoch, min-combined, so one
                    # window that absorbs a stall does not stick.
                    float(loss_acc)
                    if n_batches == 3:
                        w = time.perf_counter() - t_now
                        step_dev_s = w if step_dev_s is None else min(
                            step_dev_s, w)
                if profile_dir and epoch == 0:
                    # steady-state steps (after warm-up and calibration):
                    # batches 4-6 under torch.profiler, written as a Chrome
                    # trace. Drain before start/stop so the window holds
                    # whole steps.
                    if n_batches == 3 and profiler is None:
                        float(loss_acc)
                        profiler = start_profiler(dev)
                    elif n_batches == 6 and profiler is not None:
                        float(loss_acc)
                        stop_profiler(profiler, profile_dir,
                                      "train_trace.json")
                        profiler = None
                if sync_every and n_batches % sync_every == 0:
                    float(loss_acc)  # drains the device queue
                t_in = time.perf_counter()
                step_s += t_in - t_now
                stop_mid = _agreed_stop(preempt.check(), dev)
                if stop_mid:
                    break  # batch-boundary stop; checkpoint below
            if profiler is not None:  # epoch shorter than the trace window
                stop_profiler(profiler, profile_dir, "train_trace.json")
                profiler = None
            if stop_mid:
                # mid-epoch preemption: the partial epoch's param/opt
                # updates are kept (those batches train a second time on
                # resume, the epoch restarting from gen_epoch_start);
                # plateau/best/history are epoch-granular, so their current
                # values are the epoch-start values the resume needs.
                preempted = True
                preempt_partial = n_batches
                break
            t_now = time.perf_counter()
            avg_train_loss = (float(loss_acc) / n_batches if n_batches else 0.0)
            step_s += time.perf_counter() - t_now  # final drain is device time
            train_wall = step_s + input_s
            duty = (min(1.0, n_batches * step_dev_s / max(train_wall, 1e-9))
                    if step_dev_s else
                    step_s / max(train_wall, 1e-9))
            step_ms = (step_dev_s if step_dev_s
                       else step_s / max(n_batches, 1)) * 1000

            val = evaluate_metrics(state.params, eval_fn, valid_loader,
                                   group=group)
            history.append({"epoch": epoch, "train_loss": avg_train_loss,
                            **{f"val_{k}": v for k, v in val.items()},
                            "step_ms": step_ms, "duty": duty,
                            "step_dev_s": step_dev_s,
                            "input_s": input_s, "step_s": step_s,
                            "n_batches": n_batches,
                            "wall_s": time.time() - t0})
            if writer is not None:
                writer.add_scalar("Loss/train", avg_train_loss, epoch)
                for k, v in val.items():
                    writer.add_scalar(f"{k}/val", v, epoch)
            log(f"Epoch {epoch + 1}/{num_epochs} "
                f"train_loss={avg_train_loss:.4f} val_loss={val['loss']:.4f} "
                f"val_acc={val['accuracy']:.4f} val_f1={val['f1']:.4f} "
                f"val_auc={val['auc']:.4f} lr_scale={plateau.scale:g} "
                f"step={step_ms:.0f}ms "
                f"duty={duty:.2f} ({time.time() - t0:.1f}s)")
            if writer is not None:
                writer.add_scalar("duty_cycle/train", duty, epoch)

            plateau = plateau_update(plateau, val["accuracy"])

            if val["accuracy"] > best_metric:
                best_metric = val["accuracy"]
                best_epoch = epoch
                bad_epochs = 0
                if save_dir:
                    # async: the device->host copy happens here, the disk
                    # write overlaps the next epoch's training
                    saver.save(
                        os.path.join(save_dir, "best_model"),
                        {"params": _full(state.params, lay),
                         "opt_state": (tx.state_dict() if lay is None else
                                       _opt_tree(state.params, tx, lay))},
                        metadata={"epoch": epoch, "val_metrics": val,
                                  "args": args_metadata or {}})
            else:
                bad_epochs += 1
                log(f"No improvement for {bad_epochs} epochs.")
            if checkpoint_every and save_dir and (
                    epoch + 1) % checkpoint_every == 0:
                # preemption-safe resume point: the full train state + the
                # loop state a restart needs to continue bit-identically
                last_saver.save(
                    os.path.join(save_dir, "last"),
                    _state_tree(state, tx, lay),
                    metadata={
                        "loop": _loop_meta(epoch, plateau, best_metric,
                                           best_epoch, bad_epochs,
                                           gen.get_state(), history,
                                           random.getstate()),
                        "args": args_metadata or {}})
            if bad_epochs >= patience:
                log(f"Early stopping after {epoch + 1} epochs.")
                break

        if preempted:
            if save_dir:
                # synchronous: the write must land before this process
                # exits. The process-wide serial writer orders it after any
                # in-flight best/last write (checkpoint._SerialWriter); the
                # waits below only surface errors, and an earlier write's
                # failure must not block this write (it is the one that
                # makes the preemption resumable).
                save_checkpoint(
                    os.path.join(save_dir, "last"),
                    _state_tree(state, tx, lay),
                    metadata={
                        "loop": _loop_meta(epoch - 1, plateau, best_metric,
                                           best_epoch, bad_epochs,
                                           gen_epoch_start, history,
                                           py_rand_start),
                        "preempted": {"epoch": epoch,
                                      "batches_done": preempt_partial},
                        "args": args_metadata or {}})
            for s in (last_saver, saver):
                try:
                    s.wait()  # surface async-write errors, but keep the
                except Exception as e:  # preemption exit retriable
                    log(f"note: an async checkpoint write had failed: {e}")
            where = (os.path.join(save_dir, "last") if save_dir
                     else "NOWHERE (no save_dir — partial progress lost)")
            log(f"Preempted during epoch {epoch + 1} after {preempt_partial} "
                f"batches; resume checkpoint: {where}. Rerun the same command "
                "with --resume auto to continue.")
            raise PreemptedError(
                f"SIGTERM during epoch {epoch + 1}; resume checkpoint at "
                f"{where}")

        last_saver.wait()  # surface resume-write errors before finishing
        saver.wait()  # the last best-model write must land before restoring
        restored = bool(save_dir) and best_epoch >= 0
        log(f"Loading best model from epoch {best_epoch}" if save_dir
            else "Keeping final-epoch params (no save_dir to restore best from)")
        best_params = _full(state.params, lay)
        if restored:
            tree, _ = restore_checkpoint(os.path.join(save_dir, "best_model"))
            best_params = tree["params"]
        if final_path:
            # metadata must describe the params actually saved: without a
            # save_dir the best epoch was never checkpointed, so the final
            # artifact holds last-epoch params (early stopping guarantees
            # those are `patience` epochs worse than best).
            meta = ({"best_epoch": best_epoch, "val_accuracy": best_metric}
                    if restored else
                    {"best_epoch": None, "params_from": "final_epoch",
                     "best_val_accuracy_seen": best_metric})
            save_checkpoint(final_path, {"params": best_params}, metadata=meta)
        return best_params, history


def _world() -> int:
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _quiet(*args, **kwargs):
    """The log of every rank but 0."""


def _agreed_stop(local: bool, dev) -> bool:
    """One rank's SIGTERM flag -> a stop every rank agrees on
    (missm_tpu/train/loop.py::_agreed_stop): signals land at different
    times on different ranks, and ranks that broke at different batches
    would then issue mismatched collectives (the resume save is one). One
    all-reduce of a flag a batch."""
    if _world() == 1:
        return local
    flag = torch.tensor([1.0 if local else 0.0], device=dev)
    from ..parallel.collectives import all_reduce
    return bool(all_reduce(flag, None,
                           torch.distributed.ReduceOp.MAX).item() > 0)
