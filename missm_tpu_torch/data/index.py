"""Offline dataset prep, a copy of missm_tpu/data/index.py: label.csv
generation + A/V audio extraction.

Seed-compatible rebuilds of the reference's offline tools:
- `build_enterface_index` / `build_ave_index` / `build_mvsa_index` mirror
  src/utils/generate_index.py:7-66 (same traversal, same 80/10/10
  random.shuffle split under the same seed).
- `extract_wav` replaces convert_to_wav.py's `os.system("ffmpeg ...")` with
  the in-process native decoder (libavformat/avcodec) + windowed-sinc
  resample + stdlib wav writer — no ffmpeg binary needed.
"""
from __future__ import annotations

import os
import random
import wave
from pathlib import Path
from typing import Dict, List

import numpy as np


def _mode_split(n: int) -> List[str]:
    train_num = int(n * 0.8)
    val_num = int(n * 0.1)
    test_num = n - train_num - val_num
    mode = ["train"] * train_num + ["valid"] * val_num + ["test"] * test_num
    random.shuffle(mode)
    return mode


def build_enterface_index(data_dir: str) -> Dict[str, list]:
    """rglob *.avi; label = great-grandparent dir name (emotion)."""
    data = {"avi_path": [], "annotation": []}
    for file_path in Path(data_dir).rglob("*"):
        if (file_path.is_file()
                and not any(p.startswith(".") for p in file_path.parts)
                and file_path.suffix == ".avi"):
            data["avi_path"].append(str(file_path))
            data["annotation"].append(str(file_path).split("/")[-3])
    data["mode"] = _mode_split(len(data["annotation"]))
    return data


def build_ave_index(data_dir: str):
    import pandas as pd
    all_df = []
    for mode in ["train", "valid", "test"]:
        paths, labels = [], []
        with open(os.path.join(data_dir, f"{mode}Set_split.txt")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                paths.append(parts[0])
                labels.append("".join(parts[1:]))
        all_df.append(pd.DataFrame({"path": paths, "annotation": labels,
                                    "mode": mode}))
    return pd.concat(all_df, ignore_index=True)


def build_mvsa_index(data_dir: str) -> Dict[str, list]:
    data = {"ID": [], "language": [], "annotation": []}
    with open(os.path.join(data_dir, "labelResultAll_vote.txt")) as f:
        lines = f.readlines()
    for line in lines[1:]:
        parts = line.strip().split()
        with open(os.path.join(data_dir, "data", f"{parts[0]}.txt")) as t:
            data["language"].append(t.readlines()[0].strip())
        data["ID"].append(parts[0])
        data["annotation"].append(parts[-1])
    data["mode"] = _mode_split(len(data["annotation"]))
    return data


def write_index_csv(dataset: str, data_dir: str, seed: int = 2025) -> str:
    import pandas as pd
    random.seed(seed)
    if dataset == "eNTERFACE":
        data = build_enterface_index(data_dir)
        save_path = data_dir.replace("/data", "/label.csv")
    elif dataset == "AVE":
        data = build_ave_index(data_dir)
        save_path = os.path.join(data_dir, "label.csv")
    elif dataset == "mvsa":
        data = build_mvsa_index(data_dir)
        save_path = os.path.join(data_dir, "label.csv")
    else:
        raise ValueError(dataset)
    pd.DataFrame(data).to_csv(save_path, index=False)
    return save_path


def write_wav(path: str, waveform: np.ndarray, sample_rate: int):
    """float32 [-1, 1] -> 16-bit PCM mono wav."""
    pcm = np.clip(waveform, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def extract_wav(media_path: str, wav_path: str, sampling_rate: int = 16000):
    """media container -> mono wav at `sampling_rate`
    (convert_to_wav.py:5-12 equivalent, in-process)."""
    from ..ingest import native
    if not native.available():
        raise RuntimeError("audio extraction needs the native ingest "
                           "library (make -C cpp)")
    out = native.decode_media_audio(media_path)
    if out is None:
        raise RuntimeError(f"no decodable audio stream in {media_path}")
    wav, sr = out
    if sr != sampling_rate:
        from ..ops.resample import resample_sinc
        wav = resample_sinc(wav, sr, sampling_rate)
    write_wav(wav_path, wav, sampling_rate)


def extract_wav_tree(media_dir: str, wav_dir: str,
                     sampling_rate: int = 16000):
    """Walk mp4/avi under media_dir, mirroring convert_to_wav's __main__."""
    for file_path in Path(media_dir).rglob("*"):
        if (file_path.is_file()
                and not any(p.startswith(".") for p in file_path.parts)
                and file_path.suffix.lower() in (".mp4", ".avi")):
            target = str(file_path).replace(media_dir, wav_dir)
            target = target[: -len(file_path.suffix)] + ".wav"
            extract_wav(str(file_path), target, sampling_rate)
