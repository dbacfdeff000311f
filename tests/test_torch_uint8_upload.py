"""--uint8_upload in the port, held against the JAX package's rule
(tests/test_uint8_upload.py, cpp/ingest.cc::mi_resample_u8_u8): image,
thermal and video are resized and cropped in f32 over the raw 0-255
values and rounded half up to uint8; the model normalises them
(models/finetune.py::_dequantize).

- the port's uint8 transforms on the CPU against clip(round(denorm(f32)))
  of the JAX package's f32 transforms: at most 1e-3 of the pixels differ,
  none by more than 1 (a tie at .5 may round either way after another f32
  summation order);
- the port's forward on a uint8 batch against missm_tpu.models.finetune's
  on the same batch, tiny towers in f32, params built in JAX and bridged;
- the loaders: uint8 image and thermal, f32 depth and audio;
- cli.train, cli.test and cli.predict with --uint8_upload true on the CPU,
  the batches reaching the model as uint8.
"""
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import finetune as jft
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.ops import image_transforms as jit_
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.data.preprocess import make_media_loaders
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.ops import image_transforms as tit
from tests.synthetic import make_mvsa_tree

pytestmark = pytest.mark.filterwarnings("ignore")

TINY = ["--modality_types", "language", "image", "--model_scale", "tiny",
        "--hash_tokenizer", "--device", "cpu", "--uint8_upload", "true"]


def _denorm(x):
    """The JAX f32 path's normalise undone: [3, ...] -> the 0-255 scale."""
    shape = (3,) + (1,) * (x.ndim - 1)
    m = np.asarray(jit_.OPENAI_MEAN, np.float32).reshape(shape)
    s = np.asarray(jit_.OPENAI_STD, np.float32).reshape(shape)
    return (x * s + m) * 255.0


def _check_rounded(u8, f32):
    assert u8.dtype == torch.uint8
    expect = np.clip(np.round(_denorm(np.asarray(f32))), 0, 255)
    got = u8.numpy().astype(np.float32)
    assert got.shape == expect.shape
    assert np.mean(np.abs(got - expect) > 0.5) < 1e-3
    np.testing.assert_allclose(got, expect, atol=1.0, rtol=0)


@pytest.mark.parametrize("h,w", [(32, 32), (41, 67), (90, 60)])
def test_image_u8_is_the_rounded_jax_f32_path(h, w):
    """image_transform_u8 (image and thermal) against JAX's
    image_transform."""
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    _check_rounded(tit.image_transform_u8(img, 32, device="cpu"),
                   jit_.image_transform(img, 32))


@pytest.mark.parametrize("flip", [False, True])
def test_video_u8_is_the_rounded_jax_f32_path(flip):
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, size=(4, 45, 80, 3), dtype=np.uint8)
    u8 = tit.video_transform_u8(frames, 32, flip=flip, device="cpu")
    assert tuple(u8.shape) == (3, 4, 32, 32)
    _check_rounded(u8, jit_.video_transform(frames, 32, flip=flip))


def test_rounding_is_half_up_and_clamped():
    """floor(x + 0.5) clamped to [0, 255], as mi_resample_u8_u8 rounds
    (torch.round would take 2.5 to 2)."""
    x = torch.tensor([-3.0, -0.5, 0.49, 0.5, 1.5, 2.5, 254.5, 255.4, 300.0])
    assert tit._round_u8(x).tolist() == [0, 0, 0, 1, 2, 3, 255, 255, 255]


def test_forward_on_uint8_matches_jax():
    """missm_tpu.models.finetune.model_forward on a uint8 image batch
    against the port's, the same bridged params, f32."""
    fusion = dict(fusion_type="sum", modality_types=("language", "image"),
                  output_dims=4, feature_dims=24, fusion_dim=8)
    jcfg = jft.ModelConfig(towers=(("image", jax_tiny_tower("image")),),
                           fusion=JaxFusionConfig(**fusion),
                           compute_dtype="float32")
    tcfg = tft.ModelConfig(towers=(("image", tiny_tower("image")),),
                           fusion=FusionConfig(**fusion),
                           compute_dtype="float32")
    tree = jax.tree_util.tree_map(
        np.asarray, jft.init_model_params(jax.random.PRNGKey(0), jcfg))
    size = tcfg.tower_dict["image"].vision.image_size[0]
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(3, 3, size, size), dtype=np.uint8)
    ids = rng.integers(2, 90, size=(3, 16)).astype(np.int32)
    missing = np.array([0, 1, 4], np.int32)
    want, _ = jax.jit(lambda p, d, m: jft.model_forward(p, jcfg, d, m))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {"language": jnp.asarray(ids), "image": jnp.asarray(u8)},
        jnp.asarray(missing))
    with torch.no_grad():
        got, _ = tft.model_forward(from_jax(tree, device="cpu"), tcfg,
                                   {"language": ids,
                                    "image": torch.as_tensor(u8)},
                                   missing, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_quantized_loaders(tmp_path):
    """make_media_loaders(quantized=True): image and thermal samples are
    [3, S, S] uint8 equal to image_transform_u8 of the decoded file; depth
    and audio stay f32."""
    from PIL import Image

    from missm_tpu_torch.data import ingest_io

    rng = np.random.default_rng(1)
    img = str(tmp_path / "a.png")
    Image.fromarray(rng.integers(0, 256, (30, 44, 3), dtype=np.uint8)
                    ).save(img)
    depth = str(tmp_path / "d.png")
    Image.fromarray(rng.integers(0, 9000, (30, 40), dtype=np.uint16)
                    ).save(depth)
    wav = str(tmp_path / "a.wav")
    with wave.open(wav, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((rng.standard_normal(4000) * 3000).astype(
            "<i2").tobytes())
    towers = {m: tiny_tower(m) for m in ("image", "thermal", "depth",
                                         "audio")}
    loaders = make_media_loaders(towers, quantized=True, device="cpu")
    size = towers["image"].vision.image_size[0]
    want = tit.image_transform_u8(ingest_io.decode_image(img), size,
                                  device="cpu")
    for m in ("image", "thermal"):
        out = loaders[m](img)
        assert out.dtype == torch.uint8 and torch.equal(out, want), m
    assert loaders["depth"](depth).dtype == torch.float32
    assert loaders["audio"](wav).dtype == torch.float32


def test_cli_train_test_predict_with_uint8_upload(tmp_path, monkeypatch):
    """One tiny epoch of cli.train, a cli.test sweep and cli.predict, all
    with --uint8_upload true: every image batch reaches the model as
    uint8 and is dequantized there."""
    from missm_tpu_torch.cli.predict import main as predict_main
    from missm_tpu_torch.cli.test import main as test_main
    from missm_tpu_torch.cli.train import main as train_main

    csv = make_mvsa_tree(str(tmp_path / "mvsa"), write_media=True)
    run = tmp_path / "run"
    run.mkdir()
    monkeypatch.chdir(run)
    seen = []
    real = tft._dequantize

    def dequantize(x, dtype):
        seen.append(len(x))
        return real(x, dtype)
    monkeypatch.setattr(tft, "_dequantize", dequantize)
    base = ["--datasetName", "mvsa", "--csv_path", csv, "--fusion_type",
            "sum", *TINY]
    _, hist = train_main(base + ["--init", "random", "--batch_size", "4",
                                 "--num_epochs", "1", "--num_workers", "0"])
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    # 12 train rows in 3 steps of 4 and 6 valid rows in 2 batches
    assert len(seen) == 5, seen
    res = test_main(base + ["--test_types", "sum", "--test_missing_type",
                            "image", "--batch_size", "5"])
    assert len(res["sum"]["image"]) == 10
    assert all(np.isfinite(m["accuracy"])
               for m in res["sum"]["image"].values())
    n = len(seen)
    out = predict_main(base + ["--batch_size", "5", "--output", "p.csv"])
    assert len(out) == 10 and len(seen) == n + 2
    assert os.path.exists("p.csv") and out["pred"].between(0, 2).all()
