"""The train and eval steps, after missm_tpu/train/step.py.

The train step takes the JAX package's semantics with PyTorch's means:
frozen leaves get `requires_grad=False`, so autograd never computes their
weight gradients (the JAX package leaves them out of the differentiated
partition), and the optimizer is `torch.optim.Adam`, whose L2 weight decay
added to the gradient and bias-corrected moments are optax's
`add_decayed_weights` + `scale_by_adam`. Unlike the JAX step, which returns
new arrays, this one updates the param tensors and the optimizer state in
place: the returned state holds the same tensors.

Teacher semantics (MTD_stu, KL_stu), as in the JAX package: the teacher
shares the student's encoder, so only its fusion params are its own
(`TrainState.teacher_fusion`). Its forward runs inside every microbatch
under `torch.no_grad()`, with every modality present and in eval mode, and
for MTD_stu the step ends with the EMA update of the teacher's fusion
params toward the student's (decay 0.999).

Parallel layouts (`cfg.parallel`, a parallel.partitioning.Layout): params
and the teacher are this rank's (Layout.partition), the batch its rows
(parallel.shard_batch). Every mean of the loss divides by its count summed
over the data group (train/losses.py), so the ranks' gradients add up to
the whole batch's: after the backward, the gradients of the leaves that
are replicated over data are summed over the data group in one flat
all-reduce, and the FSDP-sharded ones were reduce-scattered by their
gather (parallel/collectives.py::gather_shard). Adam then steps on the
local leaves, so its moments are sharded with them. Under TP and pipe
nothing more is summed: a replicated leaf's gradient is computed from
replicated values on every model and pipe rank of a replica.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from ..core.device import resolve_device
from ..models.finetune import ModelConfig, model_forward, tree_map
from ..utils.profiling import span
from .losses import (cross_entropy, kl_distill_loss, masked_kl_distill,
                     masked_mse_loss, mse_loss, per_sample_cross_entropy,
                     total)
from .trainability import TRAIN, leaves, param_labels

TEACHER_TYPES = ("MTD_stu", "KL_stu")
EMA_DECAY = 0.999  # MTD_stu's teacher
SPAN_STEP = "missm.train.step"
SPAN_FORWARD = "missm.train.forward"
SPAN_BACKWARD = "missm.train.backward"
SPAN_OPTIMIZER = "missm.train.optimizer"


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any      # the optimizer's per-parameter state (tx.state)
    teacher_fusion: Any  # None unless MTD_stu / KL_stu; never requires_grad
    step: int


def partition_trainable(params, cfg: ModelConfig):
    """(treedef, trainable, frozen): `treedef` is the params' structure,
    `trainable` and `frozen` are flat leaf lists with None in the other
    side's slots. Sets requires_grad on the trainable leaves only, so
    autograd computes no gradient for a frozen one."""
    labels = leaves(param_labels(params, cfg))
    flat = leaves(params)
    for p, label in zip(flat, labels):
        p.requires_grad_(label == TRAIN)
    trainable = [p if label == TRAIN else None
                 for p, label in zip(flat, labels)]
    frozen = [None if label == TRAIN else p for p, label in zip(flat, labels)]
    return tree_map(lambda _: None, params), trainable, frozen


def combine_params(treedef, trainable, frozen):
    flat = iter([f if t is None else t for t, f in zip(trainable, frozen)])
    return tree_map(lambda _: next(flat), treedef)


def make_optimizer(params, cfg: ModelConfig, *, b1=0.9, b2=0.999, eps=1e-8,
                   weight_decay: float = 0.0):
    """Adam over the trainable leaves only (the reference's
    `Adam(filter(lambda p: p.requires_grad, ...))`). The learning rate is
    set by each step from its `lr` argument."""
    _, trainable, _ = partition_trainable(params, cfg)
    return torch.optim.Adam([p for p in trainable if p is not None], lr=0.0,
                            betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def init_train_state(params, cfg: ModelConfig, *, weight_decay: float = 0.0,
                     teacher_fusion=None):
    """(TrainState, tx) with tx the torch.optim.Adam of make_optimizer. The
    state holds a detached copy of `teacher_fusion`: the step updates it in
    place, and it must share no storage with the student's params."""
    tx = make_optimizer(params, cfg, weight_decay=weight_decay)
    if teacher_fusion is not None:
        teacher_fusion = tree_map(lambda t: t.detach().clone(),
                                  teacher_fusion)
    return TrainState(params=params, opt_state=tx.state,
                      teacher_fusion=teacher_fusion, step=0), tx


def compute_loss(params, teacher_fusion, cfg: ModelConfig, data, labels,
                 missing_index, generator, valid=None, *, device="cuda",
                 group=None):
    """(loss, logits): cross-entropy plus the fusion type's distillation
    term, every term masked to the `valid` rows (a boolean [B] mask of rows
    a fixed-shape batcher did not pad in) when given.

    MTD_stu / KL_stu: the MSE / KL between the student's and the teacher's
    distillation features; the teacher (the student's encoder and
    `teacher_fusion`) runs under no_grad with every modality present and in
    eval mode. self_distill: 0.01 times the mean over modalities of the
    masked KL between each present modality's student view and the
    teacher's features. With `group` (the data group) every count is the
    group's (losses.total): this rank's part of the whole batch's loss."""
    ft = cfg.fusion.fusion_type
    logits, aux = model_forward(params, cfg, data, missing_index, train=True,
                                generator=generator, device=device)
    labels = torch.as_tensor(labels, device=logits.device)
    missing_index = torch.as_tensor(missing_index, device=logits.device)
    if valid is None:
        ce = cross_entropy(logits, labels, group)
    else:
        valid = torch.as_tensor(valid, device=logits.device)
        nll = per_sample_cross_entropy(logits, labels)
        w = valid.to(nll.dtype)
        ce = (nll * w).sum() / torch.clamp(total(w.sum(), w, group), min=1.0)

    if ft in TEACHER_TYPES:
        with torch.no_grad():
            _, tea_aux = model_forward(
                {"encoder": params["encoder"], "fusion": teacher_fusion},
                cfg, data, torch.zeros_like(missing_index), train=False,
                device=device)
        rep_s, rep_t = aux["features"], tea_aux["features"]
        if valid is None:
            dl = (mse_loss(rep_s, rep_t, group) if ft == "MTD_stu"
                  else kl_distill_loss(rep_s, rep_t, group=group))
        else:
            dl = (masked_mse_loss(rep_s, rep_t, valid, group)
                  if ft == "MTD_stu"
                  else masked_kl_distill(rep_s, rep_t, valid, group=group))
        return dl + ce, logits

    if ft == "self_distill":
        present = aux["present_masks"]                    # [B, M]
        stu = aux["stu_features"]                         # [B, M, D]
        tea = aux["tea_features"]                         # [B, D]
        M = present.shape[1]
        dl = 0.0
        for i in range(M):
            mask = present[:, i] if valid is None else present[:, i] & valid
            dl = dl + masked_kl_distill(stu[:, i], tea, mask, group=group)
        return 0.01 * dl / M + ce, logits

    return ce, logits


def _ema(teacher, student):
    """teacher = teacher * d + student * (1 - d) in place, leaf by leaf,
    paired by key; in f32, as JAX's t * d + s * (1 - d) rounds."""
    if isinstance(teacher, Mapping):
        for k, t in teacher.items():
            _ema(t, student[k])
    else:
        teacher.mul_(EMA_DECAY).add_(student, alpha=1.0 - EMA_DECAY)


def _rows(data, sl):
    return {k: (_rows(v, sl) if isinstance(v, Mapping) else v[sl])
            for k, v in data.items()}


def make_train_step(cfg: ModelConfig, tx, accum_steps: int = 1, *,
                    device="cuda"):
    """Returns step(state, data, labels, missing_index, lr, generator[,
    valid]) -> (state, {"loss": loss}), run on `device` (params must already
    be there; data, labels and masks may be numpy arrays; `generator` feeds
    the head's dropout and lies on `device`).

    accum_steps = A > 1 splits the batch into A equal microbatches, run one
    after another, each drawing its dropout from `generator` in turn, and
    takes one Adam update. Each microbatch's loss is a mean over its valid
    rows; it is weighted by that row count over the total, so the step
    equals the full-batch masked mean (missm_tpu/train/step.py:185-205);
    self_distill's masked KL, whose normaliser is per microbatch, becomes
    the same count-weighted mean of microbatch means, as in JAX. A batch
    that A does not divide raises.

    MTD_stu and KL_stu need `state.teacher_fusion`; MTD_stu ends each step
    with the teacher's EMA update, t = t * 0.999 + s * 0.001 over the
    fusion params, in place.

    Under `cfg.parallel` the batch is this rank's rows, and its local
    microbatch i is its part of the global microbatch i (shard_batch's
    `microbatches`); the loss returned is the whole batch's."""
    dev = resolve_device(device)
    ft = cfg.fusion.fusion_type
    lay = cfg.parallel
    group = lay.data_group if lay is not None else None

    def step_fn(state: TrainState, data, labels, missing_index, lr,
                generator, valid=None):
        with span(SPAN_STEP):
            return _step(state, data, labels, missing_index, lr, generator,
                         valid)

    def _step(state, data, labels, missing_index, lr, generator, valid):
        treedef, trainable, frozen = partition_trainable(state.params, cfg)
        params = combine_params(treedef, trainable, frozen)
        train = [p for p in trainable if p is not None]
        if ft in TEACHER_TYPES and state.teacher_fusion is None:
            raise ValueError(f"{ft} trains against a teacher: pass "
                             "init_train_state(teacher_fusion=...)")
        labels = torch.as_tensor(labels, device=dev)
        missing_index = torch.as_tensor(missing_index, device=dev)
        if valid is not None:
            valid = torch.as_tensor(valid, device=dev)
        tx.zero_grad(set_to_none=True)

        if accum_steps == 1:
            with span(SPAN_FORWARD):
                loss, _ = compute_loss(params, state.teacher_fusion, cfg,
                                       data, labels, missing_index,
                                       generator, valid, device=dev,
                                       group=group)
            with span(SPAN_BACKWARD):
                loss.backward()
            loss = loss.detach()
        else:
            A = accum_steps
            if labels.shape[0] % A:
                raise ValueError(f"batch {labels.shape[0]} not divisible by "
                                 f"accum_steps {A}")
            h = labels.shape[0] // A
            if valid is None:
                valid = torch.ones(labels.shape[0], dtype=torch.bool,
                                   device=dev)
            l_sum = torch.zeros((), device=dev)
            w_sum = torch.zeros((), device=dev)
            for i in range(A):
                sl = slice(i * h, (i + 1) * h)
                w = total(valid[sl].sum().float(), valid, group)
                with span(SPAN_FORWARD):
                    loss, _ = compute_loss(params, state.teacher_fusion, cfg,
                                           _rows(data, sl), labels[sl],
                                           missing_index[sl], generator,
                                           valid[sl], device=dev,
                                           group=group)
                with span(SPAN_BACKWARD):
                    (w * loss).backward()
                l_sum = l_sum + w * loss.detach()
                w_sum = w_sum + w
            denom = torch.clamp(w_sum, min=1.0)
            for p in train:
                if p.grad is not None:
                    p.grad.div_(denom)
            loss = l_sum / denom

        # optax updates every trainable leaf, a zero gradient included
        for p in train:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if group is not None:
            loss = total(loss, loss, group)
            _sum_replicated_grads(state.params, lay, group)
        with span(SPAN_OPTIMIZER):
            for pg in tx.param_groups:
                pg["lr"] = lr
            tx.step()
            if ft == "MTD_stu":
                with torch.no_grad():
                    _ema(state.teacher_fusion, state.params["fusion"])
        return TrainState(params=state.params, opt_state=tx.state,
                          teacher_fusion=state.teacher_fusion,
                          step=state.step + 1), {"loss": loss}

    return step_fn


def _sum_replicated_grads(params, lay, group):
    """The gradients of the trainable leaves that are replicated over the
    data axis, summed over `group` in one flat all-reduce a dtype (the FSDP
    shards' were reduce-scattered by their gather)."""
    from ..core.mesh import DATA_AXIS
    from ..parallel.collectives import all_reduce
    from ..parallel.partitioning import zip_map

    grads = []

    def pick(p, spec):
        if p.requires_grad and p.grad is not None and DATA_AXIS not in spec:
            grads.append(p.grad)

    zip_map(pick, params, lay.local_specs)
    for dt in {g.dtype for g in grads}:
        same = [g for g in grads if g.dtype == dt]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in same]), group)
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))


def make_eval_step(cfg: ModelConfig, *, device="cuda"):
    """Returns eval(params, data, labels, missing_index[, valid]) ->
    dict(loss, loss_sum, count, preds, probs), run on `device` (params must
    already be there; data, labels and masks may be numpy arrays).

    `valid` is an optional boolean [B] mask: rows padded in by a fixed-shape
    batcher are left out of the loss. `loss_sum` and `count` let callers
    combine the masked mean exactly across batches or processes."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def eval_fn(params, data, labels, missing_index, valid=None):
        logits, _ = model_forward(params, cfg, data, missing_index,
                                  train=False, device=dev)
        nll = per_sample_cross_entropy(logits,
                                       torch.as_tensor(labels, device=dev))
        if valid is None:
            loss_sum = nll.sum()
            count = torch.tensor(float(nll.shape[0]), device=dev)
        else:
            v = torch.as_tensor(valid, device=dev).to(nll.dtype)
            loss_sum = (nll * v).sum()
            count = v.sum()
        loss = loss_sum / torch.clamp(count, min=1.0)
        return {"loss": loss, "loss_sum": loss_sum, "count": count,
                "preds": torch.argmax(logits, dim=-1),
                "probs": torch.softmax(logits, dim=-1)}

    return eval_fn
