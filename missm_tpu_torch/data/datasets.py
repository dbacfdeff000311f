"""Host-side datasets, after missm_tpu/data/datasets.py: CSV-driven
multimodal records with train-time random missing simulation and retrieval
substitution.

One generic `MMDataset` parameterized by a `DatasetSpec` replaces the
reference's four near-identical Dataset classes
(src/dataset/data_loader.py:17-286). Media decoding is pluggable via
`media_loaders` ({modality: fn(path_or_text) -> array or tensor}), so the
production loaders (data.preprocess) decode and transform while tests
inject synthetic loaders.

Reference-parity details:
- train missing codes are drawn with python `random.choice` from the
  dataset's code set (sims/mosi {0,1,2,3} :56-59; eNTERFACE/AVE {0,2,3}
  :131-134,196-199; mvsa {0,1,4} :261-264).
- retrieval substitutes a random same-label *other* sample's raw data for
  the missing modality, then clears the missing code (:67-72, 90-95); at
  test time the substitute comes from the train dataset (:69).
- labels come from a LabelEncoder fit over the FULL csv's annotation column
  (:306-307) — np.unique gives the same sorted-class mapping.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.config import CODE_TO_MODALITY


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    modalities: Sequence[str]
    train_missing_codes: Sequence[int]
    build: Callable  # (df, data_path) -> {modality: list of raw refs}


def _sims_mosi_build(df, data_path):
    return {
        "language": list(df["text"]),
        "video": list(data_path + "/data/" + df["video_id"].astype(str) + "/"
                      + df["clip_id"].astype(str) + ".mp4"),
        "audio": list(data_path + "/wav/" + df["video_id"].astype(str) + "/"
                      + df["clip_id"].astype(str) + ".wav"),
    }


def _enterface_build(df, data_path):
    avi = df["avi_path"].astype(str)
    return {
        "video": list(avi),
        "audio": list(avi.str.replace(".avi", ".wav", regex=False)
                      .str.replace("/data/", "/wav/", regex=False)),
    }


def _ave_build(df, data_path):
    p = df["path"].astype(str)
    return {
        "video": list(p),
        "audio": list(p.str.replace(".mp4", ".wav", regex=False)
                      .str.replace("_split/", "_split_wav/", regex=False)),
    }


def _mvsa_build(df, data_path):
    return {
        "language": list(df["language"]),
        "image": list(data_path + "/data/" + df["ID"].astype(str) + ".jpg"),
    }


DATASET_SPECS: Dict[str, DatasetSpec] = {
    "sims": DatasetSpec("sims", ("language", "video", "audio"),
                        (0, 1, 2, 3), _sims_mosi_build),
    "mosi": DatasetSpec("mosi", ("language", "video", "audio"),
                        (0, 1, 2, 3), _sims_mosi_build),
    "eNTERFACE": DatasetSpec("eNTERFACE", ("video", "audio"),
                             (0, 2, 3), _enterface_build),
    "AVE": DatasetSpec("AVE", ("video", "audio"), (0, 2, 3), _ave_build),
    "mvsa": DatasetSpec("mvsa", ("language", "image"), (0, 1, 4),
                        _mvsa_build),
}


def encode_labels(annotations) -> tuple[np.ndarray, int]:
    """sklearn LabelEncoder parity: classes sorted, ids = position."""
    classes, labels = np.unique(np.asarray(annotations), return_inverse=True)
    return labels.astype(np.int64), len(classes)


class MMDataset:
    def __init__(self, spec: DatasetSpec, df, data_path: str, labels,
                 mode: str = "train", missing: bool = False,
                 missing_index: Optional[List[int]] = None,
                 retrieval: bool = False,
                 train_dataset: "MMDataset | None" = None):
        self.spec = spec
        self.data = spec.build(df, data_path)
        self.labels = list(labels)
        self.mode = mode
        self.missing = missing
        self.missing_index = (list(missing_index)
                              if (missing and missing_index)
                              else [0] * len(self.labels))
        self.retrieval = retrieval
        self.train_dataset = train_dataset
        if retrieval and mode != "test":
            self.label2indices: Dict[int, List[int]] = {}
            for idx, label in enumerate(self.labels):
                self.label2indices.setdefault(label, []).append(idx)

    def __len__(self):
        return len(self.labels)

    def get_retrieval_data(self, current_index, label, missing_code):
        pool = self.label2indices[label]
        complete = random.choice(pool)
        while complete == current_index:
            complete = random.choice(pool)
        return self.data[CODE_TO_MODALITY[missing_code]][complete]

    def __getitem__(self, index):
        """-> (raw {modality: path-or-text}, label, missing_code)."""
        if self.mode == "train" and self.missing:
            missing_code = random.choice(list(self.spec.train_missing_codes))
        else:
            missing_code = self.missing_index[index]

        raw = {m: self.data[m][index] for m in self.spec.modalities}

        if self.retrieval and missing_code != 0:
            source = (self.train_dataset if self.mode == "test" else self)
            raw[CODE_TO_MODALITY[missing_code]] = source.get_retrieval_data(
                index, self.labels[index], missing_code)
            missing_code = 0

        return raw, self.labels[index], missing_code
