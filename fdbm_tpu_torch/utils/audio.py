"""WAV I/O and resampling without torchaudio/soundfile/librosa.

Supports PCM 8/16/24/32-bit and float32/64 WAVs (read) and writes PCM16 or
float32. Pure numpy and scipy: the port's own copy of
``fdbm_tpu/utils/audio.py``.
"""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1,1] shaped [C, L], sr)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 0xFFFE and len(data) > 0:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1 if bits in (16, 24, 32) else 3

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x << 8 >> 8).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, "<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, "<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format {audio_format}")

    if channels > 1:
        x = x.reshape(-1, channels).T
    else:
        x = x[None, :]
    return np.ascontiguousarray(x), sr


def write_wav(path: str, x: np.ndarray, sr: int, subtype: str = "pcm16") -> None:
    """Write float32 samples [L] or [C, L] to a WAV file."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None, :]
    channels, length = x.shape
    interleaved = x.T.reshape(-1)
    if subtype == "pcm16":
        pcm = np.clip(interleaved * 32768.0, -32768, 32767).astype("<i2")
        with wave.open(path, "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())
    elif subtype == "float32":
        body = interleaved.astype("<f4").tobytes()
        hdr = struct.pack(
            "<4sI4s4sIHHIIHH4sI",
            b"RIFF", 36 + len(body), b"WAVE", b"fmt ", 16, 3, channels, sr,
            sr * channels * 4, channels * 4, 32, b"data", len(body),
        )
        with open(path, "wb") as f:
            f.write(hdr + body)
    else:
        raise ValueError(f"Unknown subtype {subtype}")


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (librosa.resample replacement)."""
    if orig_sr == target_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(orig_sr), int(target_sr))
    return resample_poly(x, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)
