"""GloVe word vectorizer of the HumanML3D / KIT-ML evaluator (a copy of
motioncraft_tpu/utils/word_vectorizer.py): (300-d GloVe embedding, 15-d POS
one-hot) per 'word/POS' token.  The vectors are read from
``<meta_root>/<prefix>_{data.npy,words.pkl,idx.pkl}`` (``./data/glove``
in the evaluator); without them, and for a word they do not hold, the
vector is seeded from the md5 of the word, bit for bit the JAX package's,
so the pipeline runs (its metrics then mean nothing)."""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Tuple

import numpy as np

POS_ENUMERATOR = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5, "PRON": 6,
    "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10, "Obj_VIP": 11,
    "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}


class WordVectorizer:
    def __init__(self, meta_root: str, prefix: str, word_size: int = 300,
                 pos_size: int = 15):
        self.word_size, self.pos_size = word_size, pos_size
        self.word2vec = None
        paths = [os.path.join(meta_root, f"{prefix}_{s}")
                 for s in ("data.npy", "words.pkl", "idx.pkl")]
        if all(os.path.isfile(p) for p in paths):
            vectors = np.load(paths[0])
            # the released GloVe assets of the evaluator, pickled by its authors
            with open(paths[1], "rb") as f:
                words = pickle.load(f)
            with open(paths[2], "rb") as f:
                word2idx = pickle.load(f)
            self.word2vec = {w: vectors[word2idx[w]] for w in words}

    def _fallback_vec(self, word: str) -> np.ndarray:
        seed = int(hashlib.md5(word.encode()).hexdigest()[:8], 16)
        return np.random.RandomState(seed).randn(self.word_size).astype(np.float32) * 0.1

    def __getitem__(self, item: str) -> Tuple[np.ndarray, np.ndarray]:
        word, _, pos = item.partition("/")
        pos_vec = np.zeros(self.pos_size, np.float32)
        pos_vec[POS_ENUMERATOR.get(pos, POS_ENUMERATOR["OTHER"])] = 1.0
        if self.word2vec is not None and word in self.word2vec:
            return np.asarray(self.word2vec[word], np.float32), pos_vec
        return self._fallback_vec(word), pos_vec
