"""BEAT2 (PantoMatrix) speech-gesture recordings for the long-form gesture
evaluation and the training windows (PyTorch port of
motioncraft_tpu/data/beat2.py; host-side numpy).

  - ``load_beat2_args``: the flat YAML schema of
    ``configs/beat2/st_mogen_emage.yaml``, read by a small reader of its own
    (scalars, inline lists, comments), with the JAX package's defaults
  - the test split from ``train_test_split.csv``, filtered to
    ``training_speakers``
  - per recording: the SMPL-X flame pose npz (poses [T, 165], expressions
    [T, 100], trans [T, 3], betas), the 16 kHz wav, the TextGrid words
  - the ``onset+amplitude`` audio condition: |wav| and an onset impulse
    train at the sample rate, from the native extractor (data/native.py)
  - ``Beat2WindowDataset``: ``pose_length``-frame windows every ``stride``
    frames over a split's recordings, in the JAX package's order, cached as
    one compressed ``.npz`` under ``cache_path`` named by the JAX package's
    key, so either package reads the other's cache

Not ported, and refused: reading a reference LMDB window cache
(``Beat2LmdbDataset``: the ``lmdb`` package; ROADMAP queue 1, the rest of
training).  ``find_lmdb_cache`` finds one, and ``Beat2WindowDataset``
raises where it would read it.
"""

from __future__ import annotations

import csv
import hashlib
import os
import re
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from .native import onset_amplitude_native

TRAINING = "ROADMAP queue 1: the rest of training"

DEFAULTS = dict(
    data_path="./data/datasets/beats2/PantoMatrix/BEAT2/beat_english_v2.0.0/",
    pose_length=64, stride=20, pose_fps=30, audio_sr=16000,
    audio_rep="onset+amplitude", pose_rep="smplxflame_30",
    facial_rep="smplxflame_30", training_speakers=[2], audio_fps=16000,
    cache_path=None, new_cache=False, mean_pose_path=None, std_pose_path=None,
)

_INT = re.compile(r"[-+]?[0-9]+")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?")
_BOOL = {"true": True, "yes": True, "on": True, "false": False, "no": False, "off": False}


def _scalar(text: str):
    """One plain or quoted YAML scalar, typed as ``yaml.safe_load`` types it."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s in ("", "~") or s.lower() == "null":
        return None
    if s.lower() in _BOOL:
        return _BOOL[s.lower()]
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s) and any(ch.isdigit() for ch in s):
        return float(s)
    return s


def _strip_comment(line: str) -> str:
    """The line without a trailing ``# ...`` comment (a '#' at its start or
    after a space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def parse_flat_yaml(text: str) -> dict:
    """A flat mapping of ``key: value`` lines; a value is a scalar or an
    inline list ``[a, b]``.  Anything else (nesting, block lists, anchors)
    raises ValueError."""
    out = {}
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        if line[0].isspace() or ":" not in line:
            raise ValueError(f"line {n}: {raw!r} is not a flat 'key: value' entry")
        key, _, value = line.partition(":")
        value = value.strip()
        if value.startswith("["):
            if not value.endswith("]"):
                raise ValueError(f"line {n}: unterminated list {value!r}")
            body = value[1:-1].strip()
            out[key.strip()] = [_scalar(v) for v in body.split(",")] if body else []
        elif (value and value[0] in "{&*|>!") or value == "-" or value.startswith("- "):
            raise ValueError(f"line {n}: {value!r} is not a scalar or an inline list")
        else:
            out[key.strip()] = _scalar(value)
    return out


def load_beat2_args(path: Optional[str]) -> SimpleNamespace:
    """A BEAT2 YAML config (st_mogen_emage.yaml schema) -> a namespace over
    the defaults; a missing file gives the defaults."""
    cfg = {}
    if path and os.path.isfile(path):
        with open(path) as f:
            cfg = parse_flat_yaml(f.read())
    args = dict(DEFAULTS)
    args.update({k: v for k, v in cfg.items() if v is not None})
    return SimpleNamespace(**args)


def read_wav(path: str):
    """A PCM wav -> (sample rate, float32 in [-1, 1], channels averaged)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return sr, data


def onset_amplitude(wav: np.ndarray, sr: int = 16000) -> np.ndarray:
    """[L] audio -> [L, 2] (amplitude envelope, onset impulses), by the
    native spectral-flux extractor (``sr`` is not read: its frames are in
    samples)."""
    return onset_amplitude_native(np.asarray(wav, np.float32))


def parse_textgrid_words(path: str) -> List[tuple]:
    """The ``words`` tier of a Praat TextGrid -> [(start_s, end_s, word)]."""
    out = []
    if not os.path.isfile(path):
        return out
    xmin = xmax = None
    in_words = False
    with open(path, errors="ignore") as f:
        for raw in f:
            line = raw.strip()
            if line.startswith("name"):
                in_words = "words" in line
            if not in_words:
                continue
            if line.startswith("xmin"):
                xmin = float(line.split("=")[1])
            elif line.startswith("xmax"):
                xmax = float(line.split("=")[1])
            elif line.startswith("text"):
                text = line.split("=", 1)[1].strip().strip('"')
                if xmin is not None and xmax is not None:
                    out.append((xmin, xmax, text))
    return out


def split_recordings(args: SimpleNamespace, split: str) -> List[str]:
    """The recording names of ``split`` (train also takes "additional") whose
    speaker id is in ``training_speakers``, in the csv's order."""
    names = []
    with open(os.path.join(args.data_path, "train_test_split.csv")) as f:
        for row in csv.reader(f):
            if len(row) < 2:
                continue
            name, typ = row[0], row[1]
            if typ != split and not (split == "train" and typ == "additional"):
                continue
            try:
                speaker = int(name.split("_")[0])
            except ValueError:
                continue
            if speaker in args.training_speakers:
                names.append(name)
    return names


def load_recordings(args: SimpleNamespace, split: str = "test") -> List[dict]:
    """The whole recordings of a split, for windowed long-form evaluation:
    dicts with ``pose`` [T, 165], ``facial`` [T, 100], ``trans`` [T, 3],
    ``betas`` (when the npz has them), ``wav``, ``audio`` [T spf, 2],
    ``word_spans`` and ``name``; a recording without its pose npz is
    skipped, one without its wav gets silence."""
    spf = args.audio_sr // args.pose_fps
    out = []
    for name in split_recordings(args, split):
        pose_file = os.path.join(args.data_path, args.pose_rep, name + ".npz")
        if not os.path.isfile(pose_file):
            continue
        with np.load(pose_file, allow_pickle=True) as data:
            rec = {"name": name,
                   "pose": np.asarray(data["poses"], np.float32),
                   "facial": np.asarray(data["expressions"], np.float32),
                   "trans": np.asarray(data["trans"], np.float32)}
            if "betas" in data:
                rec["betas"] = np.asarray(data["betas"], np.float32)
        T = len(rec["pose"])
        wav_file = os.path.join(args.data_path, "wave16k", name + ".wav")
        if os.path.isfile(wav_file):
            sr, wav = read_wav(wav_file)
            rec["wav"] = wav
            rec["wav_path"] = wav_file
            rec["audio"] = onset_amplitude(wav, sr)[: T * spf]
        else:
            rec["wav"] = np.zeros(T * spf, np.float32)
            rec["audio"] = np.zeros((T * spf, 2), np.float32)
        rec["word_spans"] = parse_textgrid_words(
            os.path.join(args.data_path, "textgrid", name + ".TextGrid"))
        out.append(rec)
    return out


class Beat2WindowDataset:
    """Stride windows over the recordings of ``split``: dicts with ``pose``
    [n, 165], ``facial`` [n, 100], ``trans`` [n, 3], ``audio`` [n spf, 2]
    (zero-padded past the wav's end; silence without a wav), the
    ``words`` whose TextGrid span overlaps the window, ``name`` and
    ``start``, n = ``pose_length``.  With ``cache_path`` the windows are
    read from, or else written to, ``beat2_<split>_<key>.npz`` there
    (``new_cache`` rebuilds them).  A reference LMDB cache under
    ``cache_path`` raises unless ``new_cache`` is set."""

    def __init__(self, args: SimpleNamespace, split: str = "train"):
        self.args, self.split = args, split
        lmdb_dir = find_lmdb_cache(args, split)
        if lmdb_dir and not args.new_cache:
            raise NotImplementedError(
                f"a reference BEAT2 LMDB cache at {lmdb_dir}: Beat2LmdbDataset needs the "
                f"'lmdb' package ({TRAINING}); set new_cache to build the windows instead")
        cache = self.cache_file()
        if cache and os.path.isfile(cache) and not args.new_cache:
            with np.load(cache, allow_pickle=True) as data:
                self._windows = list(data["windows"])
        else:
            self._windows = self._build_windows()
            if cache:
                os.makedirs(os.path.dirname(cache), exist_ok=True)
                np.savez_compressed(cache, windows=np.asarray(self._windows, dtype=object))

    def cache_file(self) -> Optional[str]:
        """The window cache's path (the JAX package's name), or None."""
        a = self.args
        if not a.cache_path:
            return None
        key = hashlib.md5(repr((self.split, a.training_speakers, a.pose_length, a.stride,
                                a.audio_rep)).encode()).hexdigest()[:10]
        return os.path.join(a.cache_path, f"beat2_{self.split}_{key}.npz")

    def _build_windows(self) -> List[Dict]:
        a = self.args
        spf = a.audio_sr // a.pose_fps  # audio samples a frame
        n = a.pose_length
        windows = []
        for name in split_recordings(a, self.split):
            pose_file = os.path.join(a.data_path, a.pose_rep, name + ".npz")
            if not os.path.isfile(pose_file):
                continue
            with np.load(pose_file, allow_pickle=True) as data:
                poses = np.asarray(data["poses"], np.float32)
                facial = np.asarray(data["expressions"], np.float32)
                trans = np.asarray(data["trans"], np.float32)
            wav_file = os.path.join(a.data_path, "wave16k", name + ".wav")
            audio = None
            if os.path.isfile(wav_file):
                sr, wav = read_wav(wav_file)
                audio = onset_amplitude(wav, sr)
            spans = parse_textgrid_words(os.path.join(a.data_path, "textgrid",
                                                      name + ".TextGrid"))
            for start in range(0, len(poses) - n + 1, a.stride):
                end = start + n
                win = {"pose": poses[start:end], "facial": facial[start:end],
                       "trans": trans[start:end], "name": name, "start": start}
                if audio is None:
                    win["audio"] = np.zeros((n * spf, 2), np.float32)
                else:
                    seg = audio[start * spf:end * spf]
                    win["audio"] = np.pad(seg, ((0, n * spf - len(seg)), (0, 0)))
                t0, t1 = start / a.pose_fps, end / a.pose_fps
                win["words"] = [w for (s, e, w) in spans if w and s < t1 and e > t0]
                windows.append(win)
        return windows

    def __len__(self):
        return len(self._windows)

    def __getitem__(self, idx):
        return self._windows[idx]


def find_lmdb_cache(args: SimpleNamespace, split: str) -> Optional[str]:
    """A reference LMDB cache directory for ``split`` under ``cache_path``
    (the reference writes ``{cache_path}{split}/{pose_rep}_cache``), or
    None."""
    cp = getattr(args, "cache_path", None)
    if not cp:
        return None
    for cand in (os.path.join(cp, split, f"{args.pose_rep}_cache"),
                 os.path.join(cp, f"{args.pose_rep}_cache"), cp):
        if os.path.isfile(os.path.join(cand, "data.mdb")):
            return cand
    return None
