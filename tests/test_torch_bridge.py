"""The JAX -> port parameter bridge (missm_tpu_torch.compat.from_jax) and the
port's seeded init, held against missm_tpu.models.finetune.init_model_params."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import finetune as jft
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.models.tower import init_tower_params as jax_init_tower
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models.encoder import build_encoder_params
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.models.tower import init_tower_params

MODS = ("image", "depth")
FUSION = dict(fusion_type="sum", modality_types=("language",) + MODS,
              output_dims=3, feature_dims=24, fusion_dim=16)


def _jax_params():
    cfg = jft.ModelConfig(towers=tuple((m, jax_tiny_tower("image"))
                                       for m in MODS),
                          fusion=JaxFusionConfig(**FUSION))
    key = jax.random.PRNGKey(0)
    return key, jax.tree_util.tree_map(np.asarray,
                                       jft.init_model_params(key, cfg))


def _jax_shapes(tree, prefix=""):
    """{path: shape}, each block stack [L, ...] unrolled into L layers."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if k == "blocks":
            flat = _jax_shapes(v)
            n_layers = next(iter(flat.values()))[0]
            for i in range(n_layers):
                out.update({f"{path}/{i}/{p}": s[1:] for p, s in flat.items()})
        elif isinstance(v, dict):
            out.update(_jax_shapes(v, path + "/"))
        else:
            out[path] = tuple(np.shape(v))
    return out


def _port_shapes(tree, prefix=""):
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_port_shapes(v, path + "/"))
        else:
            out[path] = tuple(v.shape)
    return out


def test_every_jax_leaf_lands_once_with_its_shape_and_dtype():
    _, tree = _jax_params()
    port = from_jax(tree, device="cpu")
    assert _port_shapes(port) == _jax_shapes(tree)
    # values and dtypes carried over, layer by layer
    jq = tree["encoder"]["image"]["vision"]["blocks"]["attn"]["q"]
    for i, layer in enumerate(port["encoder"]["image"]["vision"]["blocks"]):
        np.testing.assert_array_equal(layer["attn"]["q"]["lora_a"].numpy(),
                                      jq["lora_a"][i])
        np.testing.assert_array_equal(layer["attn"]["q"]["w"].numpy(),
                                      jq["w"][i])
    assert all(t.dtype == torch.float32 for t in
               port["fusion"]["head"]["fc2"].values())


def test_language_branch_is_the_last_towers_text():
    key, tree = _jax_params()
    towers_keys = jax.random.split(jax.random.split(key)[0], len(MODS))
    last_text = jax.tree_util.tree_map(
        np.asarray, jax_init_tower(towers_keys[-1], jax_tiny_tower("image"))
    )["text"]
    port = from_jax(tree, device="cpu")
    np.testing.assert_array_equal(
        port["encoder"]["language"]["text"]["token_embedding"].numpy(),
        last_text["token_embedding"])
    # the port's encoder takes the same objects, not copies
    gen = torch.Generator().manual_seed(0)
    towers = {m: init_tower_params(gen, tiny_tower("image")) for m in MODS}
    enc = build_encoder_params(towers, MODS)
    assert enc["language"]["text"] is towers[MODS[-1]]["text"]
    assert enc["language"]["proj"] is towers[MODS[-1]]["text_projection"]


def test_bf16_leaves_are_bridged_bit_exact():
    x = jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16)
    got = from_jax({"w": np.asarray(x)}, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_port_init_has_the_jax_tree_and_distributions():
    _, tree = _jax_params()
    cfg = tft.ModelConfig(towers=tuple((m, tiny_tower("image")) for m in MODS),
                          fusion=FusionConfig(**FUSION))
    port = tft.init_model_params(cfg, seed=0, device="cpu")
    assert _port_shapes(port) == _jax_shapes(tree)
    again = tft.init_model_params(cfg, seed=0, device="cpu")
    np.testing.assert_array_equal(
        port["encoder"]["image"]["vision"]["patch_embedding"]["w"].numpy(),
        again["encoder"]["image"]["vision"]["patch_embedding"]["w"].numpy())
    # LoRA B starts at zero (the adapted layer starts at the base layer) and
    # LoRA A is U(+-1/sqrt(fan_in)), as peft and the JAX package draw them
    q = port["encoder"]["image"]["vision"]["blocks"][0]["attn"]["q"]
    assert not q["lora_b"].any()
    assert q["lora_a"].abs().max() <= 32 ** -0.5
    assert float(port["encoder"]["image"]["logit_scale"]) == np.float32(2.6592)
