"""The port's GPipe and 1F1B pipelines (parallel/pipeline.py) against the
JAX package's single-device train step: tiny 4-block image, video (whole
videos a microbatch, group = T) and padding-masked text (the key bias
split with the rows) towers, `sum` head, f32 on gloo CPU worlds, at 2 and
4 stages, and composed with TP as the (1, 2, 2) layout of the JAX dryrun's
3-axis mesh.

As in tests/test_torch_parallel_train.py: every rank's eval logits, the
loss and every param after one Adam step at accum_steps 1 and 2, against
missm_tpu.train.step.make_train_step / model_forward on unsharded params.
The pipeline's validation errors are held to missm_tpu's wording.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.core.mesh import make_mesh as jax_make_mesh
from missm_tpu.parallel.pipeline import PipeConfig as JaxPipeConfig
from missm_tpu.parallel.pipeline import pipeline_blocks as jax_pipeline
from missm_tpu_torch.parallel.pipeline import PipeConfig, pipeline_blocks
from tests.torch_parallel_cases import numpy_batch
from tests.torch_parallel_ref import (assert_world_matches, jax_config,
                                      jax_reference, redrawn_tree)
from tests.torch_world import run_world

TOWERS = ("image", "video")
FUSION = dict(fusion_type="sum",
              modality_types=("language", "video", "image"), output_dims=3,
              feature_dims=24, fusion_dim=16, dropout_prob=0.0)
LAYERS = 4
B, L = 8, 16
FC1 = ("encoder", "video", "vision", "blocks", 0, "mlp", "fc1", "w")


@pytest.fixture(scope="module")
def reference():
    jcfg = jax_config(TOWERS, FUSION, layers=LAYERS)
    tree = redrawn_tree(jcfg)
    batch = numpy_batch(B, L, modalities=TOWERS)
    return tree, batch, jax_reference(jcfg, tree, batch)


# (n_model, n_pipe, schedule, local blocks of a tower)
LAYOUTS = {
    "gpipe2": (1, 2, "gpipe"),
    "1f1b2": (1, 2, "1f1b"),
    "1f1b4": (1, 4, "1f1b"),
    "tp2xgpipe2": (2, 2, "gpipe"),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pipeline_train_step_matches_jax(name, reference, tmp_path):
    n_model, n_pipe, schedule = LAYOUTS[name]
    tree, batch, ref = reference
    results = run_world(
        n_model * n_pipe, "tests.torch_parallel_cases:train_case", tmp_path,
        tree=tree, batch=batch, towers=TOWERS, fusion=FUSION, layers=LAYERS,
        n_data=1, n_model=n_model, n_pipe=n_pipe, schedule=schedule,
        probe=("encoder", "video", "vision", "blocks"))
    # the stage keeps its blocks through the step
    assert all(s[2] == (LAYERS // n_pipe,) for r in results
               for s in r["steps"])
    assert_world_matches(results, ref)


class _OneStage:
    """A mesh stand-in for the validation checks: they raise before any
    collective."""
    mesh_dim_names = ("data", "model", "pipe")

    def size(self, i):
        return 2 if i == 2 else 1

    def get_local_rank(self, name):
        return 0


@pytest.mark.parametrize("rows, m, group, schedule", [
    (6, 4, 1, "gpipe"),     # rows not divisible by the microbatches
    (8, 2, 3, "gpipe"),     # microbatches not whole groups
    (8, 2, 1, "zigzag"),    # unknown schedule
])
def test_pipeline_validation_matches_jax(rows, m, group, schedule):
    """pipeline_blocks raises the JAX package's ValueError, word for
    word."""
    jmesh = jax_make_mesh(n_data=4, n_model=1, n_pipe=2)
    jpipe = JaxPipeConfig(jmesh, 2, microbatches=m, schedule=schedule)
    jblocks = {"w": jnp.zeros((2, 4))}
    with pytest.raises(ValueError) as want:
        jax_pipeline(jpipe, jblocks, jnp.zeros((rows, 4)), group=group,
                     block_fn=lambda b, x: x)
    pipe = PipeConfig(_OneStage(), 2, microbatches=m, schedule=schedule)
    with pytest.raises(ValueError) as got:
        pipeline_blocks(pipe, [{"w": torch.zeros(4)}], torch.zeros(rows, 4),
                        group=group, block_fn=lambda b, x: x)
    assert str(got.value) == str(want.value)
