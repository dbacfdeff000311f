"""The port's image+text `sum` eval step against the JAX package's.

Tiny image+text model (`tiny_tower("image")`, `sum` head), params built once
in JAX and bridged into the port; inputs made with numpy. Held against
missm_tpu.train.step.make_eval_step and missm_tpu.models.finetune.model_forward
/ embed_only, at f32 on the CPU (the port's kernels run their plain versions
there), under every missing code the benchmark draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import finetune as jft
from missm_tpu.models import fusion as jfusion
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.train.step import make_eval_step as jax_make_eval_step
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models import fusion as tfusion
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train.step import make_eval_step

B, L = 6, 16
# f32 on both sides; only the summation order of the matmuls differs
ATOL, RTOL = 2e-5, 1e-4

_jax_forward = jax.jit(jft.model_forward, static_argnums=1)


def _configs(compute_dtype="float32"):
    fusion = dict(fusion_type="sum", modality_types=("language", "image"),
                  output_dims=3, feature_dims=24, fusion_dim=16)
    jcfg = jft.ModelConfig(towers=(("image", jax_tiny_tower("image")),),
                           fusion=JaxFusionConfig(**fusion),
                           compute_dtype=compute_dtype)
    tcfg = tft.ModelConfig(towers=(("image", tiny_tower("image")),),
                           fusion=FusionConfig(**fusion),
                           compute_dtype=compute_dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def params():
    """JAX init, with every zero/one-initialised leaf (biases, LoRA B, LN)
    redrawn so that each of them reaches the logits."""
    jcfg, _ = _configs()
    tree = jax.tree_util.tree_map(
        np.asarray, jft.init_model_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)

    def redraw(x):
        if np.all(x == 0):
            return (rng.standard_normal(x.shape) * 0.05).astype(x.dtype)
        if np.all(x == 1):
            return (1 + rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x

    tree = jax.tree_util.tree_map(redraw, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), from_jax(tree,
                                                               device="cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2)
    ids = np.zeros((B, L), np.int32)
    mask = np.zeros((B, L), np.int32)
    for i, n in enumerate(rng.integers(3, L + 1, size=B)):
        ids[i, 0] = 97
        ids[i, 1:n - 1] = rng.integers(1, 97, size=n - 2)
        ids[i, n - 1] = 98  # EOT: the highest id
        mask[i, :n] = 1
    # CLIP pads after EOT, where the causal mask already hides the pads from
    # the pooled token: also mask one token before EOT in every other row,
    # so that the key bias reaches the logits
    mask[::2, 1] = 0
    image = rng.standard_normal((B, 3, 32, 32)).astype(np.float32)
    labels = rng.integers(0, 3, size=B).astype(np.int32)
    return ids, mask, image, labels


def _missing(code):
    if code == "mixed":
        return np.array([0, 1, 4, 4, 1, 0], np.int32)
    return np.full(B, code, np.int32)


def _data(inputs, lang):
    ids, mask, image, _ = inputs
    language = ids if lang == "ids" else {"input_ids": ids,
                                          "attention_mask": mask}
    return {"language": language, "image": image}


def _jax(data):
    return jax.tree_util.tree_map(jnp.asarray, data)


def _check_eval(got, ref, atol, rtol):
    for key in ("loss", "loss_sum", "count", "probs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=atol, rtol=rtol, err_msg=key)
    np.testing.assert_array_equal(got["preds"].numpy(),
                                  np.asarray(ref["preds"]))


@pytest.mark.parametrize("lang", ["ids", "mask"])
@pytest.mark.parametrize("code", [0, 1, 4, "mixed"])
def test_eval_step_matches_jax(params, inputs, code, lang):
    jparams, tparams = params
    jcfg, tcfg = _configs()
    data = _data(inputs, lang)
    labels = inputs[3]
    missing = _missing(code)

    ref_logits, _ = _jax_forward(jparams, jcfg, _jax(data),
                                      jnp.asarray(missing))
    got_logits, _ = tft.model_forward(tparams, tcfg, data, missing,
                                      device="cpu")
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(ref_logits),
                               atol=ATOL, rtol=RTOL)

    ref = jax_make_eval_step(jcfg)(jparams, _jax(data), jnp.asarray(labels),
                                   jnp.asarray(missing))
    got = make_eval_step(tcfg, device="cpu")(tparams, data, labels, missing)
    _check_eval(got, ref, ATOL, RTOL)


def test_eval_step_valid_mask_matches_jax(params, inputs):
    jparams, tparams = params
    jcfg, tcfg = _configs()
    data = _data(inputs, "mask")
    labels, missing = inputs[3], _missing("mixed")
    valid = np.array([1, 1, 1, 1, 0, 0], bool)
    ref = jax_make_eval_step(jcfg)(jparams, _jax(data), jnp.asarray(labels),
                                   jnp.asarray(missing), jnp.asarray(valid))
    got = make_eval_step(tcfg, device="cpu")(tparams, data, labels, missing,
                                             valid)
    assert float(got["count"]) == 4.0
    _check_eval(got, ref, ATOL, RTOL)


def test_bf16_encoder_matches_jax(params, inputs):
    """compute_dtype='bfloat16': the two frameworks round at different places
    (XLA fuses elementwise chains in f32, PyTorch rounds after every op), so
    after two blocks per tower the embeddings differ by a few bf16 ulps
    (2^-8 relative); the logits are held to 2e-2."""
    jparams, tparams = params
    jcfg, tcfg = _configs("bfloat16")
    data = _data(inputs, "mask")
    missing = _missing("mixed")
    ref, _ = _jax_forward(jparams, jcfg, _jax(data), jnp.asarray(missing))
    got, _ = tft.model_forward(tparams, tcfg, data, missing, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-2,
                               rtol=2e-2)
    # the fusion params never left f32
    assert all(t.dtype == torch.float32
               for t in tparams["fusion"]["head"]["fc1"].values())


def test_uint8_media_dequantize_matches_jax(params, inputs):
    jparams, tparams = params
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    data = {"language": inputs[0],
            "image": rng.integers(0, 256, size=(B, 3, 32, 32), dtype=np.uint8)}
    missing = _missing("mixed")
    ref, _ = _jax_forward(jparams, jcfg, _jax(data), jnp.asarray(missing))
    got, _ = tft.model_forward(tparams, tcfg, data, missing, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_embed_only_matches_jax(params, inputs):
    jparams, tparams = params
    jcfg, tcfg = _configs()
    data = _data(inputs, "mask")
    ref = jft.embed_only(jparams, jcfg, _jax(data))
    got = tft.embed_only(tparams, tcfg, data, device="cpu")
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)


def test_missing_masks_match_jax():
    modalities = ("language", "image", "depth")
    jcfg = JaxFusionConfig("sum", modalities, output_dims=3)
    tcfg = FusionConfig("sum", modalities, output_dims=3)
    codes = np.array([0, 1, 2, 3, 4, 1], np.int32)
    np.testing.assert_array_equal(
        tfusion.present_matrix(tcfg, torch.from_numpy(codes)).numpy(),
        np.asarray(jfusion.present_matrix(jcfg, jnp.asarray(codes))))
    tm = tfusion.missing_masks(tcfg, torch.from_numpy(codes))
    jm = jfusion.missing_masks(jcfg, jnp.asarray(codes))
    for m in modalities:
        np.testing.assert_array_equal(tm[m].numpy(), np.asarray(jm[m]))
    with pytest.raises(NotImplementedError):
        tfusion.init_fusion(torch.Generator(),
                            FusionConfig("concat", modalities, output_dims=3))
