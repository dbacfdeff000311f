"""The port's data layer (missm_tpu_torch.data.tokenizer, .ingest_io,
.datasets, .loaders, .preprocess, .index and missm_tpu_torch.ingest.native)
against the JAX package's.

Media trees come from tests/synthetic.py (`make_mvsa_tree`, real JPEGs) or
are written here with PIL and stdlib `wave`; both packages read the same
files. Python's `random` (train-time missing codes, retrieval) is seeded
alike before each package's run. Tolerances: token ids, masks, labels,
codes, paths, decoded pixels and samples and index files are exact;
images through the transforms 2e-4 abs / 1e-4 rel and the audio input
2e-3 abs / 1e-4 rel, as tests/test_torch_transforms.py holds the
transforms themselves.
"""
import json
import os
import random
import wave

import numpy as np
import pandas as pd
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.data import datasets as jds
from missm_tpu.data import index as jindex
from missm_tpu.data import ingest_io as jio
from missm_tpu.data import loaders as jloaders
from missm_tpu.data import preprocess as jpre
from missm_tpu.data import tokenizer as jtok
from missm_tpu.ingest import native as jnative
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.data import datasets as tds
from missm_tpu_torch.data import index as tindex
from missm_tpu_torch.data import ingest_io as tio
from missm_tpu_torch.data import loaders as tloaders
from missm_tpu_torch.data import preprocess as tpre
from missm_tpu_torch.data import tokenizer as ttok
from missm_tpu_torch.ingest import native as tnative
from tests.synthetic import Args, make_mvsa_tree

TRANSFORM_TOL = dict(atol=2e-4, rtol=1e-4)
AUDIO_TOL = dict(atol=2e-3, rtol=1e-4)

needs_native = pytest.mark.skipif(not jnative.available(),
                                  reason="native ingest lib not built")


@pytest.fixture(scope="module")
def mvsa(tmp_path_factory):
    """A 12/6/10-row mvsa tree with real 40x56 JPEGs."""
    return make_mvsa_tree(str(tmp_path_factory.mktemp("mvsa")),
                          write_media=True)


def _media(device="cpu"):
    """(port media loaders on `device`, JAX media loaders) for the tiny
    image tower (size 32)."""
    return (tpre.make_media_loaders({"image": tiny_tower("image")},
                                    device=device),
            jpre.make_media_loaders({"image": jax_tiny_tower("image")}))


def _assert_batches_equal(got, want):
    """Two loaders' batch lists: language, labels and codes exact, media
    within TRANSFORM_TOL."""
    assert len(got) == len(want) > 0
    for (gd, gl, gm), (wd, wl, wm) in zip(got, want):
        assert set(gd) == set(wd)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(gd["language"][k],
                                          wd["language"][k])
        img = gd["image"]
        assert torch.is_tensor(img) and img.device.type == "cpu"
        np.testing.assert_allclose(img.numpy(), wd["image"], **TRANSFORM_TOL)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gm, wm)
        assert gl.dtype == wl.dtype and gm.dtype == wm.dtype


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def _tiny_vocab(tmp_path):
    """The CLIP-format vocab of tests/test_data_missing_tokenizer.py:48-66."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789.,!?'")
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    merges = ["t h", "th e</w>", "a n", "an d</w>", "i n", "in g</w>",
              "h e</w>", "o n</w>"]
    for m in merges:
        tok = m.replace(" ", "")
        if tok not in vocab:
            vocab[tok] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    vf = tmp_path / "vocab.json"
    mf = tmp_path / "merges.txt"
    vf.write_text(json.dumps(vocab))
    mf.write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(vf), str(mf)


TEXTS = ["the cat and the dog", "Testing, one 2 three!", "he is running",
         "  Weird   spacing\tand CAPS  ", "punctuation?! on, and on.",
         "&amp;lt;html&amp;gt; café", "a " * 40]


@pytest.mark.parametrize("max_length", [8, 16, 77])
def test_clip_bpe_tokenizer_equals_jax(tmp_path, max_length):
    """missm_tpu.data.tokenizer.ClipBpeTokenizer on a vocab built here."""
    vf, mf = _tiny_vocab(tmp_path)
    got = ttok.ClipBpeTokenizer(vf, mf)(TEXTS, max_length=max_length)
    want = jtok.ClipBpeTokenizer(vf, mf)(TEXTS, max_length=max_length)
    for k in ("input_ids", "attention_mask"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_hash_and_load_tokenizer_equal_jax(tmp_path):
    """missm_tpu.data.tokenizer.HashTokenizer and load_tokenizer."""
    for vocab, ctx in ((99, 16), (49408, 77)):
        got = ttok.HashTokenizer(vocab, ctx)(TEXTS)
        want = jtok.HashTokenizer(vocab, ctx)(TEXTS)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    vf, mf = _tiny_vocab(tmp_path)
    assert isinstance(ttok.load_tokenizer(vf, mf), ttok.ClipBpeTokenizer)
    assert isinstance(ttok.load_tokenizer(allow_hash_fallback=True),
                      ttok.HashTokenizer)
    for kw, err in ((dict(vocab_file="/no/such/vocab.json"),
                     FileNotFoundError), ({}, ValueError)):
        with pytest.raises(err):
            jtok.load_tokenizer(**kw)
        with pytest.raises(err):
            ttok.load_tokenizer(**kw)


# ---------------------------------------------------------------------------
# decode: the Python fallbacks, and the native path where it is built
# ---------------------------------------------------------------------------

def _write_wav(path, pcm, sr, width, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@pytest.mark.parametrize("width,dtype,channels", [(1, np.uint8, 1),
                                                  (2, "<i2", 1),
                                                  (2, "<i2", 2),
                                                  (4, "<i4", 1)])
def test_read_audio_equals_jax(tmp_path, width, dtype, channels):
    """missm_tpu.data.ingest_io.read_audio: 8-, 16- and 32-bit PCM."""
    info = np.iinfo(dtype)
    pcm = np.random.default_rng(width).integers(
        info.min, info.max, size=800 * channels, dtype=dtype)
    p = tmp_path / "a.wav"
    _write_wav(p, pcm, 8000, width, channels)
    (got, sr), (want, sr_j) = tio.read_audio(str(p)), jio.read_audio(str(p))
    assert sr == sr_j == 8000 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.shape == (800,)


def test_decode_image_and_depth_equal_jax(tmp_path):
    """missm_tpu.data.ingest_io.decode_image (JPEG, PNG) and decode_depth
    (16-bit PNG)."""
    from PIL import Image
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(40, 56, 3), dtype=np.uint8)
    depth = rng.integers(0, 65535, size=(24, 30), dtype=np.uint16)
    for name in ("x.jpg", "x.png"):
        Image.fromarray(img).save(tmp_path / name)
    Image.fromarray(depth).save(tmp_path / "d.png")
    for name in ("x.jpg", "x.png"):
        got = tio.decode_image(str(tmp_path / name))
        assert got.dtype == np.uint8 and got.shape == (40, 56, 3)
        np.testing.assert_array_equal(got, jio.decode_image(
            str(tmp_path / name)))
    np.testing.assert_array_equal(tio.decode_image(str(tmp_path / "x.png")),
                                  img)
    got = tio.decode_depth(str(tmp_path / "d.png"))
    np.testing.assert_array_equal(got, depth)
    np.testing.assert_array_equal(got, jio.decode_depth(
        str(tmp_path / "d.png")))


def test_video_decode_needs_the_native_library(tmp_path, monkeypatch):
    """missm_tpu.data.ingest_io.decode_video: no Python fallback."""
    monkeypatch.setattr(tnative, "available", lambda: False)
    for call in (lambda: tio.decode_video(str(tmp_path / "v.avi"), 8),
                 lambda: tio.video_frame_count(str(tmp_path / "v.avi")),
                 lambda: tio.decode_video_indices(str(tmp_path / "v.avi"),
                                                  [0, 1])):
        with pytest.raises(RuntimeError, match="make -C cpp"):
            call()


@needs_native
def test_native_decode_equals_jax(tmp_path):
    """missm_tpu.ingest.native.decode_image / decode_depth / read_audio."""
    from PIL import Image
    rng = np.random.default_rng(4)
    Image.fromarray(rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
                    ).save(tmp_path / "x.jpg", quality=95)
    Image.fromarray(rng.integers(0, 65535, size=(24, 30), dtype=np.uint16)
                    ).save(tmp_path / "d.png")
    _write_wav(tmp_path / "a.wav", rng.integers(-2 ** 15, 2 ** 15 - 1, 1600,
                                                dtype="<i2"), 16000, 2)
    np.testing.assert_array_equal(tnative.decode_image(str(tmp_path / "x.jpg")),
                                  jnative.decode_image(str(tmp_path / "x.jpg")))
    np.testing.assert_array_equal(tnative.decode_depth(str(tmp_path / "d.png")),
                                  jnative.decode_depth(str(tmp_path / "d.png")))
    np.testing.assert_array_equal(
        tnative.read_audio(str(tmp_path / "a.wav"))[0],
        jnative.read_audio(str(tmp_path / "a.wav"))[0])


def test_native_load_first_call_thread_safe():
    """missm_tpu.ingest.native._load under racing first calls: every thread
    sees the same availability."""
    import threading

    tried, lib = tnative._TRIED, tnative._LIB
    try:
        tnative._TRIED, tnative._LIB = False, None
        barrier = threading.Barrier(8)
        results = []

        def go():
            barrier.wait(timeout=30)
            results.append(tnative.available())

        threads = [threading.Thread(target=go) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert results == [jnative.available()] * 8
    finally:
        tnative._TRIED, tnative._LIB = tried, lib


# ---------------------------------------------------------------------------
# datasets and loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed,epoch", [(0, 0, 0), (1, 0, 0), (7, 0, 0),
                                          (100, 3, 2), (28, 0, 5)])
def test_epoch_order_equals_jax(n, seed, epoch):
    """missm_tpu.data.loaders.epoch_order."""
    for shuffle in (True, False):
        np.testing.assert_array_equal(
            tloaders.epoch_order(n, shuffle, seed, epoch),
            jloaders.epoch_order(n, shuffle, seed, epoch))


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
def test_shard_indices_and_real_count_equal_jax(mvsa, num_shards):
    """missm_tpu.data.loaders.BatchLoader._shard_indices and
    shard_real_count on the 12 train rows."""
    args = Args(batch_size=2)
    _, tl, _ = tloaders.testing_loader(args, mvsa, None, {})
    _, jl, _ = jloaders.testing_loader(args, mvsa, None, {})
    ds_t, ds_j = tl["image"][0.5].dataset, jl["image"][0.5].dataset
    for shard in range(num_shards):
        for shuffle in (True, False):
            t = tloaders.BatchLoader(ds_t, 2, shuffle=shuffle,
                                     num_shards=num_shards, shard_index=shard)
            j = jloaders.BatchLoader(ds_j, 2, shuffle=shuffle,
                                     num_shards=num_shards, shard_index=shard)
            np.testing.assert_array_equal(t._shard_indices(),
                                          j._shard_indices())
            assert t.shard_real_count == j.shard_real_count
            assert len(t) == len(j)


def test_training_loader_batches_equal_jax(mvsa):
    """missm_tpu.data.loaders.training_loader with train_missing codes
    drawn from `random`, through the production media loaders (PIL decode,
    the device image transform on the CPU)."""
    tm, jm = _media()
    args = Args(train_missing=True, batch_size=5)
    tok = ttok.HashTokenizer(99, 16)
    got, want = [], []
    for pkg, media, out in ((tloaders, tm, got), (jloaders, jm, want)):
        random.seed(11)
        train, valid, nc = pkg.training_loader(args, mvsa, tok, media)
        assert nc == 3 and len(train) == 3 and len(valid) == 2
        out.extend(list(train) + list(valid))
    _assert_batches_equal(got, want)
    assert {int(c) for _, _, m in got for c in m} <= {0, 1, 4}


def test_testing_loader_batches_equal_jax(mvsa):
    """missm_tpu.data.loaders.testing_loader: the sweep's structure, and the
    batches of the train loader and of every mixed-type loader."""
    tm, jm = _media()
    args = Args(batch_size=4)
    tok = ttok.HashTokenizer(99, 16)
    t_train, t_test, t_nc = tloaders.testing_loader(args, mvsa, tok, tm)
    j_train, j_test, j_nc = jloaders.testing_loader(args, mvsa, tok, jm)
    assert t_nc == j_nc == 3
    assert {k: list(v) for k, v in t_test.items()} == {
        k: list(v) for k, v in j_test.items()}
    _assert_batches_equal(list(t_train), list(j_train))
    for r in t_test["mixed"]:
        _assert_batches_equal(list(t_test["mixed"][r]),
                              list(j_test["mixed"][r]))
    for mt in t_test:
        for r in t_test[mt]:
            t_ds, j_ds = t_test[mt][r].dataset, j_test[mt][r].dataset
            assert t_ds.missing_index == j_ds.missing_index


@pytest.mark.parametrize("mode", ["train", "test"])
def test_retrieval_substitution_equals_jax(mvsa, mode):
    """missm_tpu.data.datasets.MMDataset.__getitem__ with retrieval: the
    same substitutes for `random` seeded alike (train rows draw their codes
    too), and every code cleared."""
    args = Args(fusion_type="retrieval", train_missing=True)
    got, want = [], []
    for pkg, out in ((tloaders, got), (jloaders, want)):
        random.seed(5)
        if mode == "train":
            ds = pkg.training_loader(args, mvsa, None, {})[0].dataset
        else:
            ds = pkg.testing_loader(args, mvsa, None, {})[1]["mixed"][
                0.9].dataset
        out.extend(ds[i] for i in range(len(ds)) for _ in range(3))
    assert got == want
    assert all(code == 0 for _, _, code in got)


def test_csv_columns_read_as_jax_reads_them(tmp_path):
    """missm_tpu.data.loaders._read_csv and the spec builds: digit-only IDs
    and video ids are ints ("007" -> "7"), clip_id stays a string, integer
    annotations sort as integers ({2, 10} -> {0, 1}), empty text is NaN."""
    rows = {"ID": ["007", "8", "010"], "video_id": ["003", "4", "12"],
            "clip_id": ["0012", "7", "x1"], "text": ["a b", "", "c"],
            "language": ["one", "", "three"], "annotation": ["10", "2", "2"],
            "mode": ["train", "test", "train"]}
    p = tmp_path / "label.csv"
    with open(p, "w") as f:
        f.write(",".join(rows) + "\n")
        for i in range(3):
            f.write(",".join(rows[k][i] for k in rows) + "\n")
    csv = str(p)
    for name in ("mvsa", "sims"):
        args = Args(datasetName=name)
        t_train, t_valid, t_nc = tloaders.training_loader(args, csv, None, {})
        j_train, j_valid, j_nc = jloaders.training_loader(args, csv, None, {})
        assert t_nc == j_nc == 2
        for t, j in ((t_train, j_train), (t_valid, j_valid)):
            assert t.dataset.labels == j.dataset.labels
            assert set(t.dataset.data) == set(j.dataset.data)
            for m in t.dataset.data:
                assert ([str(x) for x in t.dataset.data[m]]
                        == [str(x) for x in j.dataset.data[m]])
    assert t_train.dataset.labels == [1, 0]
    sims = t_train.dataset.data
    assert sims["video"][0].endswith("/data/3/0012.mp4")
    assert sims["audio"][1].endswith("/wav/12/x1.wav")
    df = tloaders._read_csv(csv)
    assert list(df["ID"].astype(str)) == ["7", "8", "10"]
    assert np.isnan(df["language"][1])


def test_encode_labels_equals_jax():
    """missm_tpu.data.datasets.encode_labels."""
    for ann in (["pos", "neg", "neu", "pos"], [2, 10, 2, 3], ["10", "2"]):
        got, want = tds.encode_labels(ann), jds.encode_labels(ann)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_decode_pool_gives_the_sequential_batches(mvsa):
    """BatchLoader._decode_map over 4 threads, each calling the device
    transform: the same batches as one thread, stacked with torch.stack."""
    tm, _ = _media()
    tok = ttok.HashTokenizer(99, 16)
    seq = list(tloaders.training_loader(Args(batch_size=5), mvsa, tok,
                                        tm)[0])
    par = list(tloaders.training_loader(Args(batch_size=5, num_workers=4),
                                        mvsa, tok, tm)[0])
    for (sd, sl, _), (pd_, pl, _) in zip(seq, par):
        torch.testing.assert_close(pd_["image"], sd["image"], rtol=0,
                                   atol=0)
        np.testing.assert_array_equal(sl, pl)


# ---------------------------------------------------------------------------
# preprocess: the media loaders
# ---------------------------------------------------------------------------

def test_media_loaders_tag_ordered_rng_as_jax():
    """missm_tpu.data.preprocess.make_media_loaders: which loaders exist and
    which are tagged to decode on the calling thread."""
    for rr in (False, True):
        t = tpre.make_media_loaders(
            {m: tiny_tower(m) for m in ("image", "video", "audio")},
            reference_randomness=rr, device="cpu")
        j = jpre.make_media_loaders(
            {m: jax_tiny_tower(m) for m in ("image", "video", "audio")},
            reference_randomness=rr)
        assert set(t) == set(j)
        for m in t:
            assert (getattr(t[m], "ordered_rng", False)
                    == getattr(j[m], "ordered_rng", False))


@pytest.mark.parametrize("seconds,sr", [(1.5, 16000), (0.2, 16000),
                                        (1.0, 8000)])
@pytest.mark.parametrize("device_transforms", [False, True])
def test_audio_loader_matches_jax(tmp_path, monkeypatch, seconds, sr,
                                  device_transforms):
    """missm_tpu.data.preprocess.make_audio_loader: read, resample, fbank,
    chunk or tile. The port's loader has one path, torch on `device`; the
    JAX loader is taken on its host path (numpy) and with
    MISSM_DEVICE_TRANSFORMS (jnp)."""
    if device_transforms:
        monkeypatch.setenv("MISSM_DEVICE_TRANSFORMS", "1")
    pcm = (np.random.default_rng(sr).standard_normal(int(sr * seconds))
           * 6000).astype("<i2")
    p = str(tmp_path / "a.wav")
    _write_wav(p, pcm, sr, 2)
    got = tpre.make_audio_loader(tiny_tower("audio"), device="cpu")(p)
    want = np.asarray(jpre.make_audio_loader(jax_tiny_tower("audio"))(p))
    assert torch.is_tensor(got) and got.device.type == "cpu"
    assert got.shape == want.shape == (3, 32, 48)
    np.testing.assert_allclose(got.numpy(), want, **AUDIO_TOL)


@pytest.mark.parametrize("max_depth", [10.0, 0.0])
def test_depth_loader_matches_jax(tmp_path, max_depth):
    """missm_tpu.data.preprocess.make_depth_loader on a 16-bit PNG."""
    from PIL import Image
    depth = np.random.default_rng(6).integers(0, 15000, size=(50, 70),
                                              dtype=np.uint16)
    p = str(tmp_path / "d.png")
    Image.fromarray(depth).save(p)
    got = tpre.make_depth_loader(32, max_depth, device="cpu")(p)
    want = np.asarray(jpre.make_depth_loader(32, max_depth)(p))
    assert torch.is_tensor(got) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **TRANSFORM_TOL)


# ---------------------------------------------------------------------------
# index: the label.csv writers and the WAV writer
# ---------------------------------------------------------------------------

def test_index_writers_write_what_jax_writes(tmp_path):
    """missm_tpu.data.index.write_index_csv (mvsa, eNTERFACE, AVE) and
    write_wav: byte for byte."""
    mvsa = tmp_path / "mvsa"
    (mvsa / "data").mkdir(parents=True)
    lines = ["ID text image"]
    for i in range(10):
        (mvsa / "data" / f"{i}.txt").write_text(f"text, number {i}\n")
        lines.append(f"{i} positive {['neutral', 'negative'][i % 2]}")
    (mvsa / "labelResultAll_vote.txt").write_text("\n".join(lines) + "\n")
    ent = tmp_path / "ent" / "data"
    for i in range(10):
        d = ent / f"s{i}" / ["anger", "joy"][i % 2] / "sen"
        d.mkdir(parents=True)
        (d / "a.avi").write_bytes(b"")
    ave = tmp_path / "ave"
    ave.mkdir()
    for mode in ("train", "valid", "test"):
        (ave / f"{mode}Set_split.txt").write_text(
            f"{mode}/a.mp4 Church bell\n\n{mode}/b.mp4 Dog\nbad\n")
    for name, root in (("mvsa", str(mvsa)), ("eNTERFACE", str(ent)),
                       ("AVE", str(ave))):
        path = tindex.write_index_csv(name, root, seed=7)
        got = open(path, "rb").read()
        assert jindex.write_index_csv(name, root, seed=7) == path
        assert got == open(path, "rb").read()
    assert len(pd.read_csv(os.path.join(str(mvsa), "label.csv"))) == 10
    wav = np.sin(np.arange(1600) / 7.0).astype(np.float32) * 1.2
    tindex.write_wav(str(tmp_path / "t.wav"), wav, 16000)
    jindex.write_wav(str(tmp_path / "j.wav"), wav, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav"
                                                 ).read_bytes()


def test_extract_wav_needs_the_native_library(tmp_path, monkeypatch):
    """missm_tpu.data.index.extract_wav raises without the library."""
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native ingest"):
        tindex.extract_wav(str(tmp_path / "a.mp4"), str(tmp_path / "a.wav"))
