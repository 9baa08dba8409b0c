"""ctypes binding of the native onset extractor (``native/audio_features.cpp``)
for the port's speech data.

At first use the source is compiled with ``g++ -O3 -fPIC -shared
-std=c++17`` into ``build/motioncraft_tpu_torch/`` at the root of the
checkout (git-ignored), under a name that carries a hash of the source and
the flags; ``native/`` is only read.  If the library cannot be built or
loaded, this raises: the speech path has no other onset extractor, so that
its onsets are the JAX package's, which runs the same source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "audio_features.cpp"
BUILD_DIR = ROOT / "build" / "motioncraft_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"audio_features-{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The loaded extractor, compiled first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    if not SOURCE.is_file():
        raise RuntimeError(f"the onset extractor's source {SOURCE} is missing")
    path = _lib_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"cannot build the onset extractor with g++: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE} (rc {proc.returncode}):\n"
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.onset_amplitude.restype = ctypes.c_int
    lib.onset_amplitude.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return lib


def onset_amplitude_native(wav: np.ndarray) -> np.ndarray:
    """[L] float32 -> [L, 2] (|wav|, onset impulses) by spectral-flux peak
    picking (1024-sample Hann frames, hop 512, mean + std threshold)."""
    wav = np.ascontiguousarray(wav, np.float32)
    out = np.empty((len(wav), 2), np.float32)
    if len(wav) == 0:
        return out
    ret = library().onset_amplitude(wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                    len(wav), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if ret < 0:
        raise RuntimeError(f"onset_amplitude failed on {len(wav)} samples ({ret})")
    return out
