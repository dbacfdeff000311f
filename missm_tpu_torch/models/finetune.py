"""The benchmark model: multi-tower encoder + fusion head, after
missm_tpu/models/finetune.py.

Casts follow the JAX package: encoder params and media go to
`compute_dtype`, the encoder's embeddings come back as f32, and the fusion
params stay f32 throughout. Every cast is a differentiable `.to`, so in a
train step the gradients of the bf16 copies reach the f32 master params.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch

from ..core.config import TowerConfig
from ..core.device import resolve_device
from ..ops.image_transforms import OPENAI_MEAN, OPENAI_STD
from .encoder import encode, init_encoder_params
from .fusion import FusionConfig, fusion_forward, init_fusion


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """`towers` maps each non-language modality to its TowerConfig, ordered
    (the language tower is the last entry's text tower). compute_dtype:
    'bfloat16' runs the encoder in bf16; 'float32' for parity tests.
    remat: one policy for every tower, or a per-tower spec (a Mapping or a
    tuple of (modality, policy) pairs, with an optional "default"; a tower
    it does not name gets True), as encoder._remat_for resolves it. True
    recomputes every transformer block of the tower in the backward; a
    policy name (models/tower.py::REMAT_POLICIES) keeps the values it
    names.

    pipe: a parallel.pipeline.PipeConfig: every tower's blocks run as a
    pipeline over the mesh's pipe axis (missm_tpu/models/finetune.py:38-41).
    parallel: the run's parallel.partitioning.Layout (the JAX package's
    param shardings): Megatron TP in the blocks, the FSDP gather before
    use; params are then this rank's (Layout.partition)."""
    towers: Tuple[Tuple[str, TowerConfig], ...]
    fusion: FusionConfig
    use_temp: bool = True
    remat: bool | str | tuple | Mapping = False
    compute_dtype: str = "float32"
    pipe: object | None = None
    parallel: object | None = None

    @property
    def tower_dict(self):
        return dict(self.towers)


def tree_map(fn, tree):
    """fn applied to every leaf of a tree of dicts, lists and tuples (a
    param tree, or a batch)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def cast_tree(tree, dtype):
    """Every floating tensor of a param tree cast to dtype (a tensor already
    of that type is returned as it is)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def _dequantize(x, dtype):
    """uint8 media batch -> normalised CLIP input; normalised in f32, then
    cast. The channel axis is 1 for the [B, 3, H, W] and [B, 3, T, H, W]
    layouts and 4 for the 7-D retrieval-pair layout, as in the JAX
    package."""
    c_axis = 4 if x.dim() == 7 else 1
    shape = tuple(3 if i == c_axis else 1 for i in range(x.dim()))
    mean = torch.tensor(OPENAI_MEAN, device=x.device).reshape(shape)
    std = torch.tensor(OPENAI_STD, device=x.device).reshape(shape)
    return ((x.float() / 255.0 - mean) / std).to(dtype)


def _prepare_inputs(data: Mapping, dtype, device):
    """Move every input to `device`; media to `dtype` (uint8 media through
    _dequantize), language ids and masks as they are."""
    out = {}
    for k, v in data.items():
        if k == "language":
            out[k] = ({n: torch.as_tensor(t, device=device)
                       for n, t in v.items()} if isinstance(v, Mapping)
                      else torch.as_tensor(v, device=device))
            continue
        v = torch.as_tensor(v, device=device)
        out[k] = _dequantize(v, dtype) if v.dtype == torch.uint8 else v.to(dtype)
    return out


def init_model_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Seeded f32 params on `device`, drawn as the JAX package draws them
    (same distributions, not the same numbers)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return {"encoder": init_encoder_params(gen, cfg.tower_dict),
            "fusion": init_fusion(gen, cfg.fusion)}


def _gathered(cfg: ModelConfig, tree, part: str):
    """`tree` (params[part] of this rank) with its FSDP shards gathered
    (Layout.materialize); as it is without a layout."""
    lay = cfg.parallel
    if lay is None:
        return tree
    return lay.materialize(tree, lay.local_specs[part])


def _encode(params, cfg: ModelConfig, data, device, train, generator=None):
    dt = getattr(torch, cfg.compute_dtype)
    data = _prepare_inputs(data, dt, resolve_device(device))
    # cast, then gather: FSDP moves the compute type's bytes
    enc = _gathered(cfg, cast_tree(params["encoder"], dt), "encoder")
    tp = cfg.parallel.model_axis if cfg.parallel is not None else None
    embeds = encode(enc, cfg.tower_dict, data, use_temp=cfg.use_temp,
                    train=train, remat=cfg.remat, generator=generator, tp=tp,
                    pipe=cfg.pipe)
    return {k: v.float() for k, v in embeds.items()}


def model_forward(params, cfg: ModelConfig, data: Mapping, missing_index, *,
                  train: bool = False, generator: torch.Generator | None = None,
                  device="cuda"):
    """data: {'language': ids [B, L] | {'input_ids', 'attention_mask'}} and
    {modality: pixels}; returns (logits [B, output_dims] f32, aux).

    With train=True the graph is kept for a backward pass (the caller must
    not be in inference mode). `generator` (on `device`) feeds both draws
    of a train-mode call: the towers' patch dropout, where a config has it,
    then the fusion head's dropout. The JAX package splits its rng into an
    encoder part and a fusion part; one torch.Generator serves both in
    turn."""
    embeds = _encode(params, cfg, data, device, train, generator)
    missing_index = torch.as_tensor(missing_index, device=resolve_device(device))
    return fusion_forward(_gathered(cfg, params["fusion"], "fusion"),
                          cfg.fusion, embeds, missing_index, train=train,
                          generator=generator)


@torch.inference_mode()
def embed_only(params, cfg: ModelConfig, data: Mapping, *, device="cuda"):
    """Encoder-only pass at cfg.compute_dtype; f32 embeddings."""
    return _encode(params, cfg, data, device, train=False)
