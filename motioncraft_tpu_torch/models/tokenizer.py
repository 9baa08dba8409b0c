"""CLIP text tokenization.

The reference calls ``clip.tokenize(text, truncate=True)``
(reference mogen/models/transformers/diffusion_transformer.py:148).
We implement the same byte-pair-encoding scheme; the merges table
(``bpe_simple_vocab_16e6.txt.gz``) is an external asset.  When it is absent
(e.g. air-gapped CI) a deterministic hash tokenizer keeps the pipeline
runnable — embeddings are then meaningless for parity but shapes/flow are
identical.  Point ``MOTIONCRAFT_CLIP_BPE`` or ``bpe_path`` at the asset for
real runs.

A copy of the JAX package's module of the same name: the port imports
nothing of motioncraft_tpu.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import List, Optional, Sequence, Union

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@lru_cache()
def bytes_to_unicode():
    """GPT-2 byte <-> unicode table (reversible, avoids BPE on raw bytes)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text):
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text):
    return " ".join(text.split())


class ClipBPETokenizer:
    """Faithful CLIP SimpleTokenizer given the public merges file."""

    def __init__(self, bpe_path: str):
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        import re
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if False else
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE)

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens


class HashTokenizer:
    """Deterministic fallback: word -> stable hash bucket in the CLIP vocab
    range.  Keeps shape/flow identical when the BPE asset is unavailable."""

    def encode(self, text: str) -> List[int]:
        import hashlib
        out = []
        for w in whitespace_clean(basic_clean(text)).lower().split(" "):
            if not w:
                continue
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            out.append(3 + (h % (VOCAB_SIZE - 1000)))
        return out


_SOT = VOCAB_SIZE - 2  # <|startoftext|>
_EOT = VOCAB_SIZE - 1  # <|endoftext|>


def find_bpe_asset(explicit: Optional[str] = None) -> Optional[str]:
    for cand in [explicit, os.environ.get("MOTIONCRAFT_CLIP_BPE"),
                 os.path.join(os.path.dirname(__file__), "..", "..", "data",
                              "bpe_simple_vocab_16e6.txt.gz")]:
        if cand and os.path.isfile(cand):
            return cand
    return None


_tokenizer_cache = {}


def get_tokenizer(bpe_path: Optional[str] = None):
    path = find_bpe_asset(bpe_path)
    key = path or "__hash__"
    if key not in _tokenizer_cache:
        _tokenizer_cache[key] = ClipBPETokenizer(path) if path else HashTokenizer()
    return _tokenizer_cache[key]


def tokenize(texts: Union[str, Sequence[str]], context_length: int = CONTEXT_LENGTH,
             truncate: bool = True, bpe_path: Optional[str] = None) -> np.ndarray:
    """texts -> int32 [B, 77] with SOT/EOT framing, as clip.tokenize."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer(bpe_path)
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [_SOT] + tok.encode(text) + [_EOT]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"Input too long for context {context_length}: {text!r}")
            ids = ids[:context_length]
            ids[-1] = _EOT
        result[i, :len(ids)] = ids
    return result
