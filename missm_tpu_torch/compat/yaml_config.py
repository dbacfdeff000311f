"""YAML config layer (copy of missm_tpu/compat/yaml_config.py).

The reference ships a YAML config schema that no code ever loads
(src/configs/basic-config.yaml — dead code, SURVEY §2 row 15). Here the
schema is wired up: a flat or sectioned YAML file maps onto the argparse
namespace, with CLI flags taking precedence (flag > yaml > default).

Recognized sections (reference schema naming honored where it overlaps):
  dataset:   name -> datasetName, csv_path, modality_types
  training:  epochs -> num_epochs, learning_rate, batch_size, weight_decay,
             patience, seed, checkpoint_dir -> save_path, log_dir
  model:     fusion_type, fusion_dim, feature_dims, dropout_prob,
             model_scale
  evaluation: test_types, test_missing_type, model_ckpt_dir
Unknown keys that match an existing argparse attribute are applied
directly; anything else raises (typo safety). PyYAML is imported only when
a config file is read: without it, `--config` raises an ImportError that
names the package.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

_RENAMES = {
    ("dataset", "name"): "datasetName",
    ("training", "epochs"): "num_epochs",
    ("training", "checkpoint_dir"): "save_path",
}


def _flatten(doc: Dict[str, Any]):
    for key, value in doc.items():
        if isinstance(value, dict):
            for k, v in value.items():
                yield _RENAMES.get((key, k), k), v
        else:
            yield key, value


def apply_yaml_config(args: argparse.Namespace, path: str,
                      cli_overrides: set | None = None,
                      types: Dict[str, Any] | None = None
                      ) -> argparse.Namespace:
    """Merge YAML values into `args`. Keys whose flags were explicitly set
    on the command line (`cli_overrides`) win over the file.

    `types` maps argparse dests to their `type=` callables: YAML string
    values route through the same parser/validator the CLI flag uses
    (e.g. `remat: "video=false"` becomes the parsed per-modality tuple and
    a typo'd policy raises, instead of a raw string silently reaching the
    model layer)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"--config {path} needs PyYAML (the `yaml` package), which is "
            "not installed; pass the settings as flags instead") from e
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    cli_overrides = cli_overrides or set()
    types = types or {}
    for key, value in _flatten(doc):
        if key in cli_overrides:
            continue
        if not hasattr(args, key):
            raise KeyError(f"unknown config key {key!r} in {path}")
        conv = types.get(key)
        if conv is not None and isinstance(value, str):
            value = conv(value)
        elif conv is not None and isinstance(value, list):
            value = [conv(v) if isinstance(v, str) else v for v in value]
        setattr(args, key, value)
    return args


def explicit_cli_keys(parser: argparse.ArgumentParser, argv) -> set:
    """Flag names the user actually passed (so they outrank the YAML)."""
    passed = set()
    argv = list(argv or [])
    for action in parser._actions:
        for opt in action.option_strings:
            if any(a == opt or a.startswith(opt + "=") for a in argv):
                passed.add(action.dest)
    return passed
