"""The port's DP, FSDP and Megatron TP layouts against the JAX package's
single-device train step: tiny image + video (temporal MLP on) +
padding-masked text towers, `self_distill` head (its per-modality masked
means take counts summed over the data group), f32 on gloo CPU worlds.

Each world (tests/torch_world.py, own timeout) runs the eval forward of
its rows and one Adam step at accum_steps 1 and 2 from the same params;
the parent holds every rank's logits, the loss and every param after each
step against missm_tpu.train.step.make_train_step / model_forward on
unsharded params (tolerances in tests/torch_parallel_ref.py). The TP
worlds check that every LoRA factor moved: its gradient reached it; two of
them run under remat (the recompute runs the Megatron collectives again),
which changes no value.
"""
import pytest

from tests.torch_parallel_cases import numpy_batch
from tests.torch_parallel_ref import (assert_world_matches, jax_config,
                                      jax_reference, redrawn_tree)
from tests.torch_world import run_world

TOWERS = ("image", "video")
FUSION = dict(fusion_type="self_distill",
              modality_types=("language", "video", "image"), output_dims=3,
              feature_dims=24, fusion_dim=8, dropout_prob=0.0)
VISION = {"temporal_mlp": True}
B, L = 12, 16
FC1 = ("encoder", "image", "vision", "blocks", 0, "mlp", "fc1", "w")


@pytest.fixture(scope="module")
def reference():
    jcfg = jax_config(TOWERS, FUSION, vision_kw=VISION)
    tree = redrawn_tree(jcfg)
    batch = numpy_batch(B, L, modalities=TOWERS)
    return tree, batch, jax_reference(jcfg, tree, batch)


# (n_data, n_model, fsdp, the local shape of the image tower's first fc1 w,
# remat)
LAYOUTS = {
    "dp2": (2, 1, False, (32, 64), False),
    "fsdp2": (2, 1, True, (32, 32), False),
    "fsdp3": (3, 1, True, (32, 64), False),  # nothing of [L, 32, 64] by 3
    "tp2": (1, 2, False, (32, 32), False),
    "dp2xtp2": (2, 2, False, (32, 32), False),
    "tp2_remat": (1, 2, False, (32, 32), True),
    "tp2_save_most": (1, 2, False, (32, 32), "save_most"),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_train_step_matches_jax(name, reference, tmp_path):
    n_data, n_model, fsdp, fc1_shape, remat = LAYOUTS[name]
    tree, batch, ref = reference
    results = run_world(
        n_data * n_model, "tests.torch_parallel_cases:train_case", tmp_path,
        tree=tree, batch=batch, towers=TOWERS, fusion=FUSION,
        vision_kw=VISION, n_data=n_data, n_model=n_model, n_pipe=1,
        fsdp=fsdp, probe=FC1, remat=remat)
    # the FSDP and TP shards survive the step
    assert all(s[2] == fc1_shape for r in results for s in r["steps"])
    changed = ("lora_a", "lora_b") if n_model > 1 else ()
    assert_world_matches(results, ref, changed=changed)
