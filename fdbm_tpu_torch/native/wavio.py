"""ctypes bindings of the native WAV decode / crop / normalise library.

``wavio.cc`` is built at first use with ``g++ -O3 -shared -fPIC -std=c++17``
into ``fdbm_tpu_torch/_build/wavio_<hash>.so``, named by a hash of the
source and the flags, as ``ops/_build.py`` names the CUDA libraries; a
failed build raises. Nothing is built at import time. The functions return
None where the file's format is one the decoder does not take (PCM 8-bit,
float64, ...), and the caller reads it through ``utils/audio.read_wav``,
as the JAX package's loader does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "wavio.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
# The decoder's normalize_mode codes.
_NORM_MODES = {"noisy": 0, "clean": 1, "not": 2, "std": 3}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"wavio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``wavio.cc`` unless its library exists; returns its path.
    Raises if there is no ``g++`` or it fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native WAV loader is built on first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builds each install a whole library
    return path


def get_lib() -> ctypes.CDLL:
    """The library, built if needed, with its functions' signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_longlong),
                                     ctypes.POINTER(ctypes.c_int)]
            lib.wav_info.restype = ctypes.c_int
            lib.load_crop_pair.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_int, _F32, _F32]
            lib.load_crop_pair.restype = ctypes.c_int
            _lib = lib
        return _lib


def wav_info(path: str) -> Optional[Tuple[int, int, int, int]]:
    """``(sample_rate, channels, frames, bits)`` from a WAV header, None if
    the file is no RIFF/WAVE with fmt and data chunks."""
    sr, ch, bits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    frames = ctypes.c_longlong()
    if get_lib().wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                          ctypes.byref(frames), ctypes.byref(bits)) != 0:
        return None
    return sr.value, ch.value, frames.value, bits.value


def load_crop_pair_native(clean_path: str, noisy_path: str, target_len: int, start: int,
                          normalize: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode both files' channel 0, crop at ``start`` (-1: the centre) or
    pad symmetrically to ``target_len``, and divide both by the
    ``normalize`` factor (``noisy``/``clean`` peak, ``not``, ``std``: the
    noisy crop's sample standard deviation), in one native call. None where
    either file's format is not one the decoder takes."""
    if normalize not in _NORM_MODES:
        raise ValueError(f"Unknown normalize mode {normalize}")
    x = np.empty(target_len, np.float32)
    y = np.empty(target_len, np.float32)
    rc = get_lib().load_crop_pair(clean_path.encode(), noisy_path.encode(), target_len, start,
                                  _NORM_MODES[normalize], x, y)
    return (x, y) if rc == 0 else None
