"""CLIP image normalisation constants (as missm_tpu/ops/image_transforms.py)."""

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
