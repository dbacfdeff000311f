"""Static model/tower configuration (copy of missm_tpu/core/config.py).

The port keeps its own copy: importing `missm_tpu.core` pulls in JAX. The
TPU-only scheduling knob `VisionConfig.chunk_instances` is left out.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Per-sample scalar missing code: 0 = complete sample.
MODALITY_CODES = {"language": 1, "video": 2, "audio": 3, "image": 4}
CODE_TO_MODALITY = {v: k for k, v in MODALITY_CODES.items()}


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """CLIP text tower (causal mask, EOT pooling)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    projection_dim: int = 768


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP vision tower with the LanguageBind extras.

    `image_size` is (H, W): the audio tower uses a rectangular grid
    [num_mel_bins, target_length]; every other tower is square.
    """

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: Tuple[int, int] = (224, 224)
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    projection_dim: int = 768

    # LanguageBind extras
    add_time_attn: bool = False
    num_frames: int = 1
    tube_size: int = 1
    use_tube3d: bool = False
    temporal_mlp: bool = True
    force_patch_dropout: float = 0.0
    lora_r: int = 2
    lora_alpha: int = 16
    lora_dropout: float = 0.0

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.image_size[0] // self.patch_size,
                self.image_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """A full dual-encoder tower: text + vision + projections + logit scale."""

    text: TextConfig = TextConfig()
    vision: VisionConfig = VisionConfig()
    projection_dim: int = 768
    logit_scale_init: float = 2.6592  # ln(1/0.07), CLIP default

    # host-side preprocessing knobs carried alongside the tower
    num_mel_bins: int = 0
    target_length: int = 0
    audio_sample_rate: int = 16000
    audio_mean: float = -4.2677393
    audio_std: float = 4.5689974
    max_depth: float = 10.0
    video_decode_backend: str = "decord"


def languagebind_large(modality: str) -> TowerConfig:
    """Config matching the published LanguageBind_* large checkpoints
    (ViT-L/14 towers, 768-d shared projection space)."""
    text = TextConfig(hidden_size=768, intermediate_size=3072, num_layers=12,
                      num_heads=12, projection_dim=768)
    if modality == "audio":
        vision = VisionConfig(image_size=(112, 1036), patch_size=14,
                              projection_dim=768)
        return TowerConfig(text=text, vision=vision, num_mel_bins=112,
                           target_length=1036)
    if modality == "video":
        vision = VisionConfig(image_size=(224, 224), patch_size=14,
                              add_time_attn=True, num_frames=8,
                              temporal_mlp=False, projection_dim=768)
        return TowerConfig(text=text, vision=vision)
    # image / depth / thermal: square 224 ViT-L/14
    vision = VisionConfig(image_size=(224, 224), patch_size=14,
                          projection_dim=768)
    return TowerConfig(text=text, vision=vision)


def tiny_tower(modality: str = "image", **overrides) -> TowerConfig:
    """A tiny tower for CPU tests."""
    text = TextConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                      num_layers=2, num_heads=2, max_position_embeddings=16,
                      projection_dim=24)
    vkw = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
               image_size=(32, 32), patch_size=16, projection_dim=24, lora_r=2)
    if modality == "video":
        vkw.update(add_time_attn=True, num_frames=4, temporal_mlp=False)
    if modality == "audio":
        vkw.update(image_size=(32, 48))
    vkw.update(overrides)
    extras = {}
    if modality == "audio":
        extras = dict(num_mel_bins=32, target_length=48)
    return TowerConfig(text=text, vision=VisionConfig(**vkw),
                       projection_dim=24, **extras)
