"""CLIP BPE tokenization, pure Python, a copy of
missm_tpu/data/tokenizer.py.

A self-contained byte-level BPE with HF `CLIPTokenizer` semantics:
lowercasing + whitespace cleanup, the CLIP token regex, bytes->unicode
mapping, `</w>` end-of-word merges, bos/eos wrapping, truncation to 77 and
max-length padding with the eos token. The encoded [B, 77] int32 batch is
what goes to the device.

Vocab files (vocab.json + merges.txt) are the standard CLIP release format.
`HashTokenizer` is a deterministic stand-in for environments without vocab
files (tests, smoke runs) — same output contract, not CLIP-compatible.
"""
from __future__ import annotations

import functools
import html
import json
from typing import Dict, List, Optional

import numpy as np

try:
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore

try:
    import ftfy
except ImportError:  # pragma: no cover
    ftfy = None  # failed imports are NOT cached — don't retry per call

_PAT = r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte->unicode table (printable chars stay themselves)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class ClipBpeTokenizer:
    def __init__(self, vocab_file: str, merges_file: str,
                 context_length: int = 77):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().split("\n")
        # skip the version header line if present
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.pat = re.compile(_PAT, re.IGNORECASE)
        self.context_length = context_length
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.bos_id = self.encoder[self.bos_token]
        self.eos_id = self.encoder[self.eos_token]
        self.unk_id = self.eos_id  # HF CLIPTokenizer unk == eos
        self.cache = {self.bos_token: self.bos_token,
                      self.eos_token: self.eos_token}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        # HF CLIPTokenizer's basic_clean is ftfy.fix_text + the double
        # html.unescape; without ftfy, mojibake-damaged text (e.g. 'Ã©'
        # that ftfy repairs to 'é') tokenizes differently than the
        # reference pipeline (docs/PARITY.md).
        if ftfy is not None:
            text = ftfy.fix_text(text)
        text = whitespace_clean(html.unescape(html.unescape(text))).lower()
        toks: List[str] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            toks.extend(self.bpe(token).split(" "))
        return toks

    def encode_ids(self, text: str) -> List[int]:
        return [self.encoder.get(t, self.unk_id) for t in self.tokenize(text)]

    def __call__(self, texts, max_length: Optional[int] = None,
                 padding: str = "max_length", truncation: bool = True):
        """Returns {'input_ids': [B, L] int32, 'attention_mask': [B, L]} —
        the contract of the reference's tokenizer call
        (data_loader.py:76: max_length=77, padding='max_length',
        truncation=True)."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.context_length
        ids = np.full((len(texts), L), self.eos_id, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        for i, t in enumerate(texts):
            body = self.encode_ids(t)
            if truncation:
                body = body[: L - 2]
            seq = [self.bos_id] + body + [self.eos_id]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class HashTokenizer:
    """Deterministic fallback tokenizer (stable hashing into a fixed vocab).
    Output contract matches ClipBpeTokenizer; NOT CLIP-compatible — for
    tests and environments without CLIP vocab files."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1

    def __call__(self, texts, max_length: Optional[int] = None,
                 padding: str = "max_length", truncation: bool = True):
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.context_length
        ids = np.full((len(texts), L), self.eos_id, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        for i, t in enumerate(texts):
            words = whitespace_clean(t).lower().split(" ")
            import zlib
            body = [zlib.crc32(w.encode()) % (self.vocab_size - 2)
                    for w in words if w][: L - 2]
            seq = [self.bos_id] + body + [self.eos_id]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_tokenizer(vocab_file: Optional[str] = None,
                   merges_file: Optional[str] = None,
                   context_length: int = 77,
                   allow_hash_fallback: bool = False):
    """ClipBpeTokenizer from vocab/merges files; the HashTokenizer stand-in
    only by explicit opt-in.

    A configured-but-missing vocab path is a hard error: silently swapping
    in the CRC32 hash tokenizer keeps the model running while producing
    garbage text embeddings (real-checkpoint eval would quietly
    underperform). `allow_hash_fallback=True` (the CLI's --hash_tokenizer)
    is the only way to run without CLIP vocab files."""
    import os
    if vocab_file or merges_file:
        missing = [p for p in (vocab_file, merges_file)
                   if not (p and os.path.exists(p))]
        if missing:
            raise FileNotFoundError(
                "tokenizer vocab/merges configured but not found: "
                f"{missing} — fix the paths or pass --hash_tokenizer to "
                "opt into the non-CLIP hash tokenizer")
        return ClipBpeTokenizer(vocab_file, merges_file, context_length)
    if not allow_hash_fallback:
        raise ValueError(
            "no tokenizer vocab configured: pass --vocab_file/--merges_file "
            "(CLIP BPE) or explicitly opt into --hash_tokenizer")
    return HashTokenizer(context_length=context_length)
