"""Argparse surfaces mirroring the reference CLIs flag for flag, after
missm_tpu/compat/args.py.

`train_args()` mirrors train_ddp.py:19-47, `test_args()` mirrors
test.py:15-40 (same names, same defaults: reference configs run
unchanged), plus the JAX package's extras with the same names and
defaults. Each extra either runs as in the JAX package or, where its
feature is not ported, raises when given anything but its default; none
is silently ignored:

  runs:   --config, --model_scale, --init, --checkpoint_dir, --vocab_file,
          --merges_file, --hash_tokenizer, --reference_randomness,
          --video_decode_backend, --remat true|false|a named policy (also
          per modality),
          --grad_accum, --checkpoint_every, --resume, --profile_dir,
          --bf16, --frozen_bf16, --device
  raises: --mesh_model > 1, --fsdp, --mesh_pipe > 1, --pipe_microbatches,
          --pipe_schedule 1f1b and --distributed (parallel layouts, ROADMAP
          queue 1 item 9); --uint8_upload true (the data layer has no
          quantized upload)

`--device` (the port's `device=`) defaults to `cuda` in both parsers, as
the JAX package's test parser defaults to `tpu`; `--device cpu` runs the
plain PyTorch path.
"""
from __future__ import annotations

import argparse


def _bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes")


def _distributed(v):
    """--distributed value: a bool ('true' = initialize from the launcher
    env) or an explicit 'coordinator_ip:port,num_processes,process_id'
    rendezvous triple. A malformed triple is a loud parse error (silently
    coercing it to False would run single-process with no warning). Any
    value but false then raises in _finalize: not ported (item 9)."""
    s = str(v).strip()
    if "," not in s and ":" not in s:
        # only explicit bool words take the quiet path: '10.0.0.1' (a
        # forgotten :port,N,i) or 'ture' must not coerce to False
        low = s.lower()
        if low in ("1", "true", "yes", "0", "false", "no", ""):
            return low in ("1", "true", "yes")
        raise argparse.ArgumentTypeError(
            f"--distributed {v!r}: expected true/false or "
            f"'coordinator_ip:port,num_processes,process_id'")
    parts = s.split(",")
    if len(parts) != 3 or ":" not in parts[0]:
        raise argparse.ArgumentTypeError(
            f"--distributed {v!r}: expected true/false or "
            f"'coordinator_ip:port,num_processes,process_id'")
    addr, n, pid = (p.strip() for p in parts)
    try:
        n_i, pid_i = int(n), int(pid)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--distributed {v!r}: num_processes and process_id must be "
            f"integers")
    if n_i < 1 or not (0 <= pid_i < n_i):
        raise argparse.ArgumentTypeError(
            f"--distributed {v!r}: need num_processes >= 1 and "
            f"0 <= process_id < num_processes")
    return (addr, n_i, pid_i)


_REMAT_POLICIES = ("save_attn", "save_attn_mlp", "save_attn_mlp_kern",
                   "save_attn_mlp_qkv", "save_attn_mlp_qkv_kern",
                   "save_attn_mlp_qkv_sig", "save_attn_mlp_qkv_tkern",
                   "save_attn_mlp_tqkv", "save_most")


def _remat_value(val):
    """One remat value: a policy name or a bool. A typo'd policy is a loud
    parse error, not a silent False."""
    val = str(val).strip()
    if val in _REMAT_POLICIES:
        return val
    low = val.lower()
    if low in ("1", "true", "yes"):
        return True
    if low in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(
        f"unknown remat policy {val!r}; expected true/false or one of "
        f"{', '.join(_REMAT_POLICIES)}")


def _remat(v):
    if "=" in str(v):
        # per-modality spec, e.g. "video=true,audio=false" with an optional
        # default entry ("default=true"); parsed to a hashable tuple of
        # pairs, resolved per tower by models.encoder._remat_for
        out = []
        for kv in str(v).split(","):
            k, _, val = kv.partition("=")
            out.append((k.strip(), _remat_value(val)))
        return tuple(out)
    return _remat_value(v)


def _common_model_flags(p: argparse.ArgumentParser):
    p.add_argument("--feature_dims", type=int, default=768,
                   help="the output dims of languagebind")
    p.add_argument("--fusion_dim", type=int, default=256)
    p.add_argument("--dropout_prob", type=float, default=0.1)


_ITEM9 = "not ported: parallel layouts are ROADMAP queue 1 item 9"


def _extras(p: argparse.ArgumentParser):
    p.add_argument("--config", type=str, default=None,
                   help="YAML config file (flags override file values); "
                        "needs PyYAML")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model, the steps and the media "
                        "transforms run: cuda (the default) or cpu (the "
                        "plain PyTorch path)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel axis size; only 1 runs (> 1 is "
                        f"{_ITEM9})")
    p.add_argument("--fsdp", action="store_true",
                   help=f"ZeRO-3-style sharding over the data axis; {_ITEM9}")
    p.add_argument("--mesh_pipe", type=int, default=1,
                   help="pipeline-parallel stages; only 1 runs (> 1 is "
                        f"{_ITEM9})")
    p.add_argument("--pipe_microbatches", type=int, default=0,
                   help=f"microbatches per pipelined call; only 0 runs "
                        f"({_ITEM9})")
    p.add_argument("--pipe_schedule", type=str, default="gpipe",
                   choices=["gpipe", "1f1b"],
                   help=f"pipeline schedule; only gpipe, the default, "
                        f"runs (1f1b is {_ITEM9})")
    p.add_argument("--model_scale", type=str, default="large",
                   choices=["large", "tiny"])
    p.add_argument("--init", type=str, default="checkpoint",
                   choices=["checkpoint", "random"],
                   help="checkpoint: convert the LanguageBind checkpoints "
                        "under --checkpoint_dir; random: seeded init")
    p.add_argument("--checkpoint_dir", type=str, default="./cache_dir")
    p.add_argument("--vocab_file", type=str, default=None)
    p.add_argument("--merges_file", type=str, default=None)
    p.add_argument("--hash_tokenizer", action="store_true",
                   help="explicitly opt into the deterministic CRC32 hash "
                        "tokenizer (NOT CLIP-compatible; tests/smoke only). "
                        "Without this flag a missing vocab/merges path is a "
                        "hard error")
    p.add_argument("--reference_randomness", type=_bool, default=False)
    p.add_argument("--video_decode_backend", type=str, default="decord",
                   choices=["decord", "opencv", "pytorchvideo"],
                   help="frame-sampling semantics (reference "
                        "configuration_video.py:205)")
    p.add_argument("--remat", type=_remat, default=True,
                   help="true (recompute each tower block in the backward, "
                        "keeping only its input), false, a named policy "
                        "that also keeps the values it names ("
                        + ", ".join(_REMAT_POLICIES) + "), or a "
                        "per-modality spec like "
                        "'video=save_attn_mlp_qkv_tkern,audio=false'")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step: the "
                        "batch splits into N equal microbatches run one "
                        "after another inside the step (one Adam update). "
                        "batch_size must be divisible by N")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="write a preemption-safe resume checkpoint "
                        "(params, optimizer state and loop state) to "
                        "<save_path>/last every N epochs, asynchronously "
                        "off the train path (0 = off). Not in the reference "
                        "(it always restarts from scratch)")
    p.add_argument("--resume", type=str, default=None,
                   help="resume training from a --checkpoint_every or "
                        "SIGTERM checkpoint: a path, or 'auto' to pick up "
                        "<save_path>/last when it exists (fresh start "
                        "otherwise); continuation is exact: same dropout "
                        "stream, plateau scheduler, best/early-stop "
                        "counters")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="trace steady-state train steps (epoch-0 batches "
                        "4-6) with torch.profiler and write a Chrome trace "
                        "(train_trace.json) to this directory")
    p.add_argument("--bf16", type=_bool, default=True,
                   help="run the towers in bfloat16 (the fusion head "
                        "stays f32)")
    p.add_argument("--frozen_bf16", action="store_true",
                   help="store the frozen (non-LoRA vision-block) params "
                        "in bf16: bit-identical under --bf16 compute, which "
                        "casts them anyway; requires --bf16")
    p.add_argument("--uint8_upload", type=_bool, default=False,
                   help="only false runs: the port's data layer resizes "
                        "on the card and has no quantized host upload")
    p.add_argument("--distributed", type=_distributed, default=False,
                   help=f"multi-process rendezvous; only false runs "
                        f"({_ITEM9})")


def train_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    # dataset (train_ddp.py:22-25)
    parser.add_argument("--train_mode", type=str, default="classification",
                        help="regression or classification")
    parser.add_argument("--datasetName", type=str, default="mvsa",
                        help="support mosi/sims/eNTERFACE/AVE/mvsa")
    parser.add_argument("--csv_path", type=str,
                        default="./datasets/mvsa_multiple/label.csv")
    parser.add_argument("--modality_types", type=str, nargs="+",
                        default=["language", "image"],
                        help="subset of language/video/audio/image, ordered")
    # missing (train_ddp.py:28)
    parser.add_argument("--train_missing", type=_bool, default=False)
    # model (train_ddp.py:31-34)
    _common_model_flags(parser)
    parser.add_argument(
        "--fusion_type", type=str, default="sum",
        help="sum/concat/regression/retrieval/intra_attention/"
             "inter_attention/graph_fusion/unified_graph/dedicated_dnn/"
             "[Distill_tea/MTD_stu/KL_stu]/self_distill")
    # training (train_ddp.py:37-46)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--num_epochs", type=int, default=50)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0)
    parser.add_argument("--patience", type=int, default=8)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--save_path", type=str, default="checkpoints")
    parser.add_argument("--log_dir", type=str, default="logs")
    _extras(parser)
    return _finalize(parser, argv)


def test_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    # dataset (test.py:18-21)
    parser.add_argument("--train_mode", type=str, default="classification")
    parser.add_argument("--datasetName", type=str, default="eNTERFACE",
                        help="support mosi/sims/eNTERFACE")
    parser.add_argument("--csv_path", type=str,
                        default="./datasets/eNTERFACE/label.csv")
    parser.add_argument("--modality_types", type=str, nargs="+",
                        default=["video", "audio"])
    # missing (test.py:24)
    parser.add_argument("--test_missing_type", type=str, nargs="+",
                        default=["video", "audio", "mixed"],
                        help="language/video/audio/mixed")
    # model (test.py:27-32)
    parser.add_argument("--model_ckpt_dir", type=str, default="./final_model",
                        help="the ckpt of models")
    _common_model_flags(parser)
    parser.add_argument("--fusion_type", type=str, default="self_distill")
    parser.add_argument("--test_types", type=str, nargs="+",
                        default=["self_distill"],
                        help="fusion type or concat_zero/concat_median/"
                             "concat_mean")
    # other (test.py:35-38; --device comes with the extras)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--missing_index_path", type=str, default=None)
    _extras(parser)
    return _finalize(parser, argv)


def _finalize(parser: argparse.ArgumentParser, argv):
    args = parser.parse_args(argv)
    if args.config:
        from .yaml_config import apply_yaml_config, explicit_cli_keys
        import sys
        raw = argv if argv is not None else sys.argv[1:]
        types = {a.dest: a.type for a in parser._actions
                 if a.type is not None}
        apply_yaml_config(args, args.config, explicit_cli_keys(parser, raw),
                          types=types)
    # the extras whose features are not ported: anything but the default
    # is an error, never ignored
    unported = [(args.mesh_model != 1, f"--mesh_model {args.mesh_model}"),
                (args.fsdp, "--fsdp"),
                (args.mesh_pipe != 1, f"--mesh_pipe {args.mesh_pipe}"),
                (args.pipe_microbatches != 0,
                 f"--pipe_microbatches {args.pipe_microbatches}"),
                (args.pipe_schedule != "gpipe",
                 f"--pipe_schedule {args.pipe_schedule}"),
                (args.distributed is not False,
                 f"--distributed {args.distributed}")]
    for given, flag in unported:
        if given:
            parser.error(f"{flag} is {_ITEM9}")
    if args.uint8_upload:
        parser.error("--uint8_upload true is not ported: the port's data "
                     "layer resizes on the card and has no quantized host "
                     "upload")
    accum = args.grad_accum
    if accum < 1:
        parser.error(f"--grad_accum must be >= 1, got {accum}")
    if accum > 1 and args.batch_size % accum:
        parser.error(f"--batch_size {args.batch_size} must be divisible by "
                     f"--grad_accum {accum} (equal microbatches)")
    if args.checkpoint_every < 0:
        parser.error(f"--checkpoint_every must be >= 0, got "
                     f"{args.checkpoint_every}")
    if isinstance(args.remat, tuple):
        # keys can only be checked here, against the run's modalities: a
        # typo'd key ("adio=...") would otherwise fall through to the
        # default policy
        known = set(args.modality_types or []) | {"default"}
        unknown = sorted(k for k, _ in args.remat if k not in known)
        if unknown:
            parser.error(
                f"--remat names unknown modalities {unknown}; this run's "
                f"modality_types are {sorted(known - {'default'})}")
    return args


# keep pytest from collecting this API name (it mirrors the reference's
# test.py parser)
test_args.__test__ = False  # type: ignore[attr-defined]
