"""The parallel layouts (DP, FSDP, Megatron TP, the GPipe and 1F1B
pipelines) on a torch DeviceMesh, after missm_tpu/parallel."""
from .partitioning import (FSDP_MIN_SIZE, Layout, make_layout,  # noqa: F401
                           param_pspecs, partition_params, shard_batch)
from .pipeline import PipeConfig, pipeline_blocks  # noqa: F401
