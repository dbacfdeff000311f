"""Shared CLI plumbing, after missm_tpu/cli/common.py: model construction
from args, tokenizer and media-loader wiring, checkpoint-based
initialization, and the parallel layouts' startup: the process group
(`maybe_init_distributed`), the mesh (`setup_mesh`), the layout and this
rank's params (`setup_layout`), the pipeline batch check and the eval
batch rounding. One process drives one device; `--batch_size` is a
rank's (the reference's per-device DDP batch), and each data rank reads
its shard of the rows.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

import torch

from ..core.cache import enable_compilation_cache
from ..core.config import TowerConfig, languagebind_large, tiny_tower
from ..core.device import resolve_device
from ..core.mesh import DATA_AXIS, axis_size, local_batch_size, make_mesh
from ..data.preprocess import make_media_loaders
from ..data.tokenizer import HashTokenizer, load_tokenizer
from ..models.encoder import build_encoder_params
from ..models.finetune import ModelConfig, init_model_params, tree_map
from ..models.fusion import FusionConfig, init_fusion
from ..parallel.partitioning import make_layout
from ..parallel.pipeline import PipeConfig

# fusion types that force train-time missing simulation
# (reference train_ddp.py:163-164)
FORCE_TRAIN_MISSING = ("regression", "unified_graph", "dedicated_dnn",
                       "MTD_stu", "KL_stu", "self_distill")

# the reference's `LanguageBind/<name>` hub layout, cached locally
CHECKPOINT_NAMES = {"image": "LanguageBind_Image",
                    "video": "LanguageBind_Video",
                    "audio": "LanguageBind_Audio",
                    "depth": "LanguageBind_Depth",
                    "thermal": "LanguageBind_Thermal"}


def clip_modalities(modality_types):
    return [m for m in modality_types if m != "language"]


def build_tower_cfgs(args) -> Dict[str, TowerConfig]:
    mods = clip_modalities(args.modality_types)
    if not mods:
        raise ValueError("need at least one non-language modality (the "
                         "language tower aliases the last vision tower's "
                         "text encoder, as in the reference)")
    build = languagebind_large if args.model_scale == "large" else tiny_tower
    cfgs = {m: build(m) for m in mods}
    backend = getattr(args, "video_decode_backend", None)
    if backend and "video" in cfgs:
        cfgs["video"] = dataclasses.replace(cfgs["video"],
                                            video_decode_backend=backend)
    return cfgs


def build_model_config(args, num_classes: int, mesh=None) -> ModelConfig:
    """The run's ModelConfig; with `--mesh_pipe` > 1 its PipeConfig on
    `mesh` (the layout joins it in setup_layout)."""
    towers = build_tower_cfgs(args)
    feature_dims = args.feature_dims
    if args.model_scale == "tiny":
        feature_dims = next(iter(towers.values())).projection_dim
    fusion = FusionConfig(
        fusion_type=args.fusion_type,
        modality_types=tuple(args.modality_types),
        output_dims=num_classes,
        feature_dims=feature_dims,
        fusion_dim=args.fusion_dim,
        dropout_prob=args.dropout_prob,
    )
    pipe = None
    n_pipe = getattr(args, "mesh_pipe", 1)
    if n_pipe > 1:
        if mesh is None:
            raise ValueError("--mesh_pipe > 1 needs the mesh (setup_mesh "
                             "first)")
        pipe = PipeConfig(mesh, n_pipe=n_pipe,
                          microbatches=getattr(args, "pipe_microbatches", 0),
                          schedule=getattr(args, "pipe_schedule", "gpipe"))
    return ModelConfig(towers=tuple(towers.items()), fusion=fusion,
                       remat=getattr(args, "remat", False),
                       compute_dtype=("bfloat16"
                                      if getattr(args, "bf16", False)
                                      else "float32"),
                       pipe=pipe)


def _load_torch_state_dict(ckpt_dir: str):
    for name in ("pytorch_model.bin", "model.safetensors"):
        p = os.path.join(ckpt_dir, name)
        if os.path.exists(p):
            if name.endswith(".bin"):
                return torch.load(p, map_location="cpu", weights_only=True)
            try:
                from safetensors.torch import load_file
            except ImportError as e:
                raise ImportError(
                    f"{p} needs the `safetensors` package, which is not "
                    "installed") from e
            return load_file(p)
    raise FileNotFoundError(
        f"no checkpoint (pytorch_model.bin / model.safetensors) in "
        f"{ckpt_dir}")


def init_params(args, cfg: ModelConfig, seed: int):
    """The model's params on `args.device`. --init random: the seeded init
    (models/finetune.py::init_model_params). --init checkpoint: convert the
    LanguageBind checkpoints found under `checkpoint_dir/LanguageBind_<M>`,
    then inject fresh LoRA into each vision tower and init the fusion head,
    both drawn from one generator seeded with `seed` (the JAX package
    splits a key; the numbers differ, the distributions do not)."""
    dev = resolve_device(getattr(args, "device", "cuda"))
    if args.init == "random":
        return init_model_params(cfg, seed=seed, device=dev)

    from ..compat.convert import convert_tower_state_dict
    from ..models.tower import inject_lora

    gen = torch.Generator(device=dev).manual_seed(seed)
    towers = {}
    for m, tcfg in cfg.tower_dict.items():
        sd = _load_torch_state_dict(os.path.join(args.checkpoint_dir,
                                                 CHECKPOINT_NAMES[m]))
        tp = convert_tower_state_dict(sd, tcfg, device=dev)
        # the reference applies LoRA after loading (modeling_image.py:772)
        tp["vision"] = inject_lora(gen, tp["vision"], tcfg.vision)
        towers[m] = tp
    encoder = build_encoder_params(towers, list(cfg.tower_dict))
    return {"encoder": encoder, "fusion": init_fusion(gen, cfg.fusion)}


def make_tokenizer(args):
    any_tower = next(iter(build_tower_cfgs(args).values()))
    context = any_tower.text.max_position_embeddings
    text_vocab = any_tower.text.vocab_size
    tok = load_tokenizer(args.vocab_file, args.merges_file,
                         context_length=context,
                         allow_hash_fallback=getattr(args, "hash_tokenizer",
                                                     False))
    if isinstance(tok, HashTokenizer):
        tok.vocab_size = text_vocab
        tok.bos_id = text_vocab - 2
        tok.eos_id = text_vocab - 1
    return tok


def make_loader_fns(args):
    """The media loaders of the run's towers, their transforms on
    `args.device`; uint8 image, thermal and video under --uint8_upload."""
    return make_media_loaders(
        build_tower_cfgs(args),
        reference_randomness=getattr(args, "reference_randomness", False),
        seed=args.seed, quantized=getattr(args, "uint8_upload", False),
        device=getattr(args, "device", "cuda"))


def to_device(tree, device):
    """A restored param tree (CPU tensors) moved to `device`."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), tree)


# ---------------------------------------------------------------------------
# The parallel layouts' startup
# ---------------------------------------------------------------------------


def maybe_init_distributed(args, backend: str | None = None) -> bool:
    """Join the process group of `--distributed` (the reference's NCCL
    `init_process_group`, train_ddp.py:145): 'true' reads torchrun's env
    (RANK, WORLD_SIZE, MASTER_ADDR/PORT; LOCAL_RANK picks the card), a
    'host:port,N,i' triple rendezvouses over tcp:// (a 'file://...' address
    over that file). The backend is NCCL on the card and gloo on the CPU
    unless `backend` says otherwise (a library caller's choice; there is no
    flag). On the card `args.device` becomes this rank's `cuda:LOCAL_RANK`.
    Returns whether a group is up."""
    import torch.distributed as dist

    spec = getattr(args, "distributed", False)
    if spec is False:
        return dist.is_available() and dist.is_initialized()
    dev = resolve_device(getattr(args, "device", "cuda"))
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if isinstance(spec, tuple):
            addr, n, rank = spec
            method = addr if addr.startswith("file://") else f"tcp://{addr}"
            dist.init_process_group(backend, init_method=method,
                                    world_size=n, rank=rank)
        else:
            dist.init_process_group(backend)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        local %= max(1, torch.cuda.device_count())
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
    return True


def _parallel(args) -> bool:
    return (getattr(args, "mesh_model", 1) > 1 or getattr(args, "fsdp", False)
            or getattr(args, "mesh_pipe", 1) > 1)


def setup_mesh(args, backend: str | None = None):
    """The run's (data, model[, pipe]) mesh over every rank, or None for a
    one-process run without a layout flag (the one-device path). Points
    the kernel build cache first (core/cache.py)."""
    enable_compilation_cache()
    up = maybe_init_distributed(args, backend)
    if not up:
        if _parallel(args):
            raise SystemExit("--mesh_model, --fsdp and --mesh_pipe need "
                             "--distributed (one process a device)")
        return None
    dev = resolve_device(getattr(args, "device", "cuda"))
    return make_mesh(n_model=getattr(args, "mesh_model", 1),
                     n_pipe=getattr(args, "mesh_pipe", 1),
                     device_type=dev.type)


def setup_layout(args, cfg: ModelConfig, params, mesh):
    """(cfg with its Layout, this rank's params) for the full tree
    `params`; (cfg, params) without a mesh."""
    if mesh is None:
        return cfg, params
    lay = make_layout(params, mesh, tp=getattr(args, "mesh_model", 1) > 1,
                      fsdp=getattr(args, "fsdp", False),
                      pipe=getattr(args, "mesh_pipe", 1) > 1,
                      towers=cfg.tower_dict)
    return dataclasses.replace(cfg, parallel=lay), lay.partition(params)


def validate_pipe_batch(args, mesh) -> None:
    """The train-time --mesh_pipe constraint, checked once the mesh
    exists: a rank's per-step batch (--batch_size, after the --grad_accum
    split) must divide into M whole pipeline microbatches; a clear exit
    instead of a ValueError deep inside the first step. (The JAX package
    checks the global batch, which GSPMD splits; here each data rank
    pipelines its own rows.)"""
    n_pipe = getattr(args, "mesh_pipe", 1)
    if n_pipe <= 1:
        return
    m = getattr(args, "pipe_microbatches", 0) or n_pipe
    accum = getattr(args, "grad_accum", 1)
    per_step = args.batch_size // accum
    if args.batch_size % accum or per_step % m:
        raise SystemExit(
            f"--mesh_pipe {n_pipe}: --batch_size {args.batch_size}"
            + (f" / --grad_accum {accum}" if accum > 1 else "")
            + f" = {per_step} rows per step is not divisible into {m} "
              f"pipeline microbatches"
            + (f" (--pipe_microbatches {m})" if m != n_pipe else ""))


def round_eval_batch(args, mesh) -> int:
    """The (global) eval batch rounded up to a multiple of the data axis
    times, under --mesh_pipe, the pipeline microbatch count M; each data
    rank's loaders then take args.batch_size / n_data rows a batch (the
    eval pads partial batches, so the metrics do not change). Returns the
    rank's batch."""
    mult = axis_size(mesh, DATA_AXIS)
    if getattr(args, "mesh_pipe", 1) > 1:
        mult *= getattr(args, "pipe_microbatches", 0) or args.mesh_pipe
    args.batch_size = -(-args.batch_size // mult) * mult
    return local_batch_size(args.batch_size, mesh)

