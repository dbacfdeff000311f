"""The port's host preprocessing ops (missm_tpu_torch.ops.resize, .resample,
.image_transforms, .melfbank) against the JAX package's.

Inputs are made with numpy from a seed; the JAX functions run on the CPU.
Tolerances:
- the numpy matrix and table code and the host twins (`resize_matrix`,
  `crop_resize_weights` against the JAX package's bucket-padded matrices
  with the zero padding cut off, `resample_sinc`, `mel_banks`,
  `kaldi_fbank_host`, the frame indices) are copies: exact;
- image, video and depth transforms: the same matrices on both sides, the
  products summed in another order: 2e-4 abs / 1e-4 rel, as
  tests/test_host_transforms.py holds the JAX package's host and device
  transforms to each other;
- the fbank: 2e-4 abs / 1e-4 rel, as tests/test_melfbank.py holds it to its
  golden; the model input, whose log-mels are divided by 2 std and whose
  small energies amplify f32 differences through the log: 2e-3 abs / 1e-4
  rel (tests/test_host_transforms.py:77).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from missm_tpu.ingest import native as jnative
from missm_tpu.ops import image_transforms as jit_
from missm_tpu.ops import melfbank as jmel
from missm_tpu.ops import resample as jresample
from missm_tpu.ops import resize as jresize
from missm_tpu_torch.ingest import native as tnative
from missm_tpu_torch.ops import image_transforms as tit
from missm_tpu_torch.ops import melfbank as tmel
from missm_tpu_torch.ops import resample as tresample
from missm_tpu_torch.ops import resize as tresize

TRANSFORM_TOL = dict(atol=2e-4, rtol=1e-4)
FBANK_TOL = dict(atol=2e-4, rtol=1e-4)
AUDIO_TOL = dict(atol=2e-3, rtol=1e-4)
AUDIO_MEAN, AUDIO_STD = -4.2677393, 4.5689974


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


# ---------------------------------------------------------------------------
# resize matrices, resample: copies, equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,antialias", [("bicubic", True),
                                              ("bicubic", False),
                                              ("bilinear", False),
                                              ("bilinear", True)])
@pytest.mark.parametrize("sizes", [(56, 24), (24, 56), (97, 32)])
def test_resize_matrix_equals_jax(method, antialias, sizes):
    """missm_tpu.ops.resize.resize_matrix: the same matrix, bit for bit."""
    np.testing.assert_array_equal(
        tresize.resize_matrix(*sizes, method, antialias),
        jresize.resize_matrix(*sizes, method, antialias))


@pytest.mark.parametrize("h,w,size", [(240, 320, 224), (320, 240, 224),
                                      (41, 67, 32), (64, 64, 32)])
def test_short_side_resize_shape_equals_jax(h, w, size):
    """missm_tpu.ops.resize.short_side_resize_shape."""
    assert (tresize.short_side_resize_shape(h, w, size)
            == jresize.short_side_resize_shape(h, w, size))


@pytest.mark.parametrize("orig,new,n", [(44100, 16000, 4410),
                                        (8000, 16000, 800),
                                        (16000, 16000, 100)])
def test_resample_sinc_equals_jax(orig, new, n):
    """missm_tpu.ops.resample.resample_sinc."""
    wav = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(tresample.resample_sinc(wav, orig, new),
                                  jresample.resample_sinc(wav, orig, new))


# ---------------------------------------------------------------------------
# image / video / depth transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,flip", [(40, 56, False), (64, 96, True),
                                      (23, 41, False)])
def test_crop_resize_weights_equal_jax_unpadded(h, w, flip):
    """missm_tpu.ops.image_transforms.crop_resize_weights: the JAX
    package's bucket-padded matrices are the port's, width one transposed,
    with zero columns after them."""
    for method, aa in (("bicubic", True), ("bilinear", False)):
        mh, mwt = tit.crop_resize_weights(h, w, 32, method, aa, flip)
        jh, jw = jit_.crop_resize_weights(h, w, 32, method, aa, flip)
        assert mh.dtype == mwt.dtype == np.float32
        assert mh.flags.c_contiguous and mwt.flags.c_contiguous
        np.testing.assert_array_equal(mh, jh[:, :h])
        np.testing.assert_array_equal(mwt, jw[:, :w].T)
        assert not jh[:, h:].any() and not jw[:, w:].any()


@pytest.mark.parametrize("h,w,size", [(40, 56, 32), (64, 96, 32),
                                      (96, 64, 224), (23, 41, 32)])
def test_image_transform_matches_jax(h, w, size):
    """missm_tpu.ops.image_transforms.image_transform (bucket-padded source
    and weights there, unpadded here)."""
    img = _u8(h * 100 + w, (h, w, 3))
    got = tit.image_transform(img, size, device="cpu")
    want = np.asarray(jit_.image_transform(img, size))
    assert got.shape == want.shape == (3, size, size)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **TRANSFORM_TOL)


@pytest.mark.parametrize("flip", [False, True])
def test_video_transform_matches_jax(flip):
    """missm_tpu.ops.image_transforms.video_transform (normalise before the
    bilinear resample), flip on and off."""
    frames = _u8(3, (4, 48, 64, 3))
    got = tit.video_transform(frames, 32, flip=flip, device="cpu")
    want = np.asarray(jit_.video_transform(frames, 32, flip=flip))
    assert got.shape == want.shape == (3, 4, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, **TRANSFORM_TOL)


@pytest.mark.parametrize("max_depth", [10.0, 0.0])
def test_depth_transform_matches_jax(max_depth):
    """missm_tpu.ops.image_transforms.depth_transform; 50x70 pads to the
    64x96 bucket there, so max_depth 0 exercises the JAX kernel's max over
    the valid region only."""
    raw = np.random.default_rng(4).integers(0, 12000, size=(50, 70)).astype(
        np.float32)
    got = tit.depth_transform(raw, 32, max_depth, device="cpu")
    want = np.asarray(jit_.depth_transform(raw, 32, max_depth))
    assert got.shape == want.shape == (3, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, **TRANSFORM_TOL)


def test_transforms_take_tensors_and_leave_them_alone():
    """A tensor source gives the numpy source's result and is not written."""
    img = _u8(5, (40, 56, 3))
    t = torch.from_numpy(img.copy())
    np.testing.assert_array_equal(tit.image_transform(t, 32, device="cpu"),
                                  tit.image_transform(img, 32, device="cpu"))
    np.testing.assert_array_equal(t.numpy(), img)
    raw = torch.full((20, 30), 4000.0)
    tit.depth_transform(raw, 32, 0.0, device="cpu")
    assert bool((raw == 4000.0).all())


def test_transforms_keep_only_host_matrices_between_calls():
    """The resize matrices of every source size stay in a bounded host
    cache of numpy arrays; no tensor outlives a call."""
    tit.crop_resize_weights.cache_clear()
    for h in range(20, 30):
        tit.image_transform(_u8(h, (h, 41, 3)), 16, device="cpu")
    info = tit.crop_resize_weights.cache_info()
    assert info.maxsize == 256 and info.currsize == 10
    mh, mwt = tit.crop_resize_weights(29, 41, 16, "bicubic", True)
    assert isinstance(mh, np.ndarray) and isinstance(mwt, np.ndarray)
    assert mh.shape == (16, 29) and mwt.shape == (41, 16)


@pytest.mark.parametrize("t,n", [(10, 4), (300, 8), (7, 7), (5, 1),
                                 (1000, 3)])
def test_frame_indices_equal_jax(t, n):
    """missm_tpu.ops.image_transforms.uniform_frame_indices and
    uniform_temporal_subsample_indices (held to JAX's, not to a card's
    torch.linspace)."""
    np.testing.assert_array_equal(tit.uniform_frame_indices(t, n),
                                  jit_.uniform_frame_indices(t, n))
    np.testing.assert_array_equal(
        tit.uniform_temporal_subsample_indices(t, n),
        jit_.uniform_temporal_subsample_indices(t, n))


def test_native_library_resolves_as_jax_does():
    """missm_tpu.ingest.native._find_lib / available: the port's file sits
    at the same depth, so it finds the same library, or none."""
    assert tnative._find_lib() == jnative._find_lib()
    assert tnative.available() == jnative.available()


# ---------------------------------------------------------------------------
# fbank
# ---------------------------------------------------------------------------

def test_fbank_tables_equal_jax():
    """missm_tpu.ops.melfbank.mel_banks, _hann, num_frames."""
    for bins in (24, 112):
        cfg_t, cfg_j = tmel.FbankConfig(num_mel_bins=bins), \
            jmel.FbankConfig(num_mel_bins=bins)
        np.testing.assert_array_equal(tmel.mel_banks(cfg_t),
                                      jmel.mel_banks(cfg_j))
        assert cfg_t.padded_window_size == cfg_j.padded_window_size == 512
    np.testing.assert_array_equal(tmel._hann(400), jmel._hann(400))
    for n in (0, 399, 400, 16000, 31999):
        assert (tmel.num_frames(n, tmel.FbankConfig())
                == jmel.num_frames(n, jmel.FbankConfig()))
    for total, target in ((50, 16), (17, 16), (16, 16), (200, 48)):
        for a, b in zip(tmel.chunk_ranges(total, target),
                        jmel.chunk_ranges(total, target)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [16000, 3210, 400])
def test_kaldi_fbank_matches_jax(n):
    """missm_tpu.ops.melfbank.kaldi_fbank, and kaldi_fbank_host equal."""
    wav = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = tmel.kaldi_fbank(torch.from_numpy(wav), tmel.FbankConfig(
        num_mel_bins=24))
    want = np.asarray(jmel.kaldi_fbank(jnp.asarray(wav), jmel.FbankConfig(
        num_mel_bins=24)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **FBANK_TOL)
    np.testing.assert_array_equal(
        tmel.kaldi_fbank_host(wav, tmel.FbankConfig(num_mel_bins=24)),
        jmel.kaldi_fbank_host(wav, jmel.FbankConfig(num_mel_bins=24)))


# frames at 16 kHz: 2 s -> 198 (long: 3 chunks), 0.3 s -> 28 (short: tile),
# 400 + 47 * 160 samples -> exactly 48, 300 samples -> under one window
@pytest.mark.parametrize("n", [32000, 4800, 400 + 47 * 160, 300])
def test_audio_model_input_matches_jax(n):
    """missm_tpu.ops.melfbank.audio_model_input (bucket-padded waveform
    there), and audio_model_input_host equal, at 32 bins x 48 frames."""
    rng = np.random.default_rng(n)
    wav = rng.standard_normal(n).astype(np.float32)
    wav = wav - wav.mean()
    target = 48
    T = tmel.num_frames(n, tmel.FbankConfig())
    if T > target:
        r0, r1, r2 = tmel.chunk_ranges(T, target)
        idx = (int(r0[-1]), int(r1[0]), int(r2[-1]))
    else:
        idx = (0, 0, 0)
    got = tmel.audio_model_input(wav, tmel.FbankConfig(num_mel_bins=32),
                                 target, idx, AUDIO_MEAN, AUDIO_STD,
                                 device="cpu")
    want = np.asarray(jmel.audio_model_input(
        wav, jmel.FbankConfig(num_mel_bins=32), target, idx, AUDIO_MEAN,
        AUDIO_STD))
    assert got.shape == want.shape == (3, 32, 48)
    np.testing.assert_allclose(got.numpy(), want, **AUDIO_TOL)
    if n >= 400:  # the host twin frames nothing under one window
        np.testing.assert_array_equal(
            tmel.audio_model_input_host(wav, tmel.FbankConfig(
                num_mel_bins=32), target, idx, AUDIO_MEAN, AUDIO_STD),
            jmel.audio_model_input_host(wav, jmel.FbankConfig(
                num_mel_bins=32), target, idx, AUDIO_MEAN, AUDIO_STD))


@pytest.mark.parametrize("T,chunks", [(50, (0, 17, 34)), (6, (0, 0, 0)),
                                      (16, (0, 0, 0))])
def test_waveform_to_model_input_matches_jax(T, chunks):
    """missm_tpu.ops.melfbank.waveform_to_model_input: chunk, tile, stack."""
    mel = np.random.default_rng(T).standard_normal((T, 8)).astype(np.float32)
    got = tmel.waveform_to_model_input(torch.from_numpy(mel), 16, chunks,
                                       0.5, 0.25)
    want = np.asarray(jmel.waveform_to_model_input(jnp.asarray(mel), 16,
                                                   chunks, 0.5, 0.25))
    assert got.shape == want.shape == (3, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

