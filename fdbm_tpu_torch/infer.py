"""Single-utterance inference.

Port of ``fdbm_tpu/infer.py:enhance_single``: read, resample to 16 kHz,
normalise, pad to a 64-frame bucket, enhance, trim, renormalise with the
clipping guard, write. A file longer than ``max_seconds`` (30 s) is
enhanced in overlapping chunks, each its own utterance, and cross-faded
back together over 16 frames, as ``BucketedEnhancer.enhance_many`` and
``_enhance_long`` do (``fdbm_tpu/infer.py:256-286, 376-410``). Folder
serving (``BucketedEnhancer``, ``enhance_folder``) is not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fdbm_tpu_torch.model import FDBM, normalisation
from fdbm_tpu_torch.utils.audio import read_wav, resample, write_wav

BUCKET_FRAMES = 64
# A result that peaks above 1 is rescaled to this peak (the reference
# single-file CLI uses 0.5, its folder CLI 0.95).
CLIP_SCALE = 0.5
# Cross-fade between the chunks of a long file, in STFT frames.
OVERLAP_FRAMES = 16


def bucket_length(n_samples: int, hop_length: int, frames_multiple: int = BUCKET_FRAMES) -> int:
    """Smallest multiple of ``frames_multiple * hop`` samples >= n_samples."""
    quantum = max(1, frames_multiple) * hop_length
    return max(quantum, -(-n_samples // quantum) * quantum)


def pad_to(audio: np.ndarray, length: int) -> np.ndarray:
    """Reflect-tile ``audio`` up to ``length`` samples (or cut it), so the
    padded tail keeps natural statistics."""
    if len(audio) >= length:
        return audio[:length]
    reps = np.concatenate([audio, audio[::-1]])
    return np.tile(reps, -(-length // len(reps)))[:length]


def chunk_starts(n_samples: int, max_len: int, hop_length: int) -> Tuple[int, List[int]]:
    """``(chunk_len, starts)`` of the chunks a file of ``n_samples`` longer
    than ``max_len`` is cut into: whole hops, overlapping by
    ``OVERLAP_FRAMES`` frames (``fdbm_tpu/infer.py:_enhance_long``)."""
    overlap = OVERLAP_FRAMES * hop_length
    chunk_len = max_len - max_len % hop_length
    step = chunk_len - overlap
    return chunk_len, list(range(0, max(1, n_samples - overlap), step))


def overlap_add(total_len: int, segments: Sequence[Tuple[int, np.ndarray]],
                ramp_len: int) -> np.ndarray:
    """Cross-fade reassembly of ``(start, enhanced_chunk)`` segments:
    linear ramps of ``ramp_len`` samples at interior chunk edges, weights
    normalised where chunks overlap (``BucketedEnhancer._overlap_add``)."""
    out = np.zeros(total_len, np.float64)
    weight = np.zeros(total_len, np.float64)
    for s, e in segments:
        n = len(e)
        w = np.ones(n)
        ramp = min(ramp_len, n)
        if s > 0:
            w[:ramp] = np.linspace(0, 1, ramp, endpoint=False)
        if s + n < total_len:
            w[n - ramp:] = np.minimum(w[n - ramp:], np.linspace(1, 0, ramp, endpoint=False))
        out[s:s + n] += e * w
        weight[s:s + n] += w
    return (out / np.maximum(weight, 1e-8)).astype(np.float32)


def _enhance_utterance(fdbm: FDBM, audio: np.ndarray, generator: torch.Generator,
                       sampler_type: Optional[str], N: Optional[int],
                       sampler_kwargs: dict, exact_shape: bool) -> np.ndarray:
    """One utterance: normalise, bucket pad, enhance, trim, renormalise
    with the clipping guard."""
    norm = normalisation(audio, fdbm.cfg.normalize)
    blen = bucket_length(len(audio), fdbm.cfg.hop_length, 1 if exact_shape else BUCKET_FRAMES)
    batch = torch.as_tensor(pad_to((audio / norm).astype(np.float32), blen)[None],
                            device=fdbm.device)
    enhanced = fdbm.enhance_batch(batch, generator, sampler_type=sampler_type, N=N,
                                  **sampler_kwargs)
    x = enhanced[0, :len(audio)].cpu().numpy() * norm
    peak = np.max(np.abs(x))
    if peak > 1.0:
        x = x / peak * CLIP_SCALE
    return x.astype(np.float32)


def enhance_single(fdbm: FDBM, noisy_file: str, output_file: str,
                   sampler_type: Optional[str] = None, N: Optional[int] = None,
                   target_sr: int = 16000, seed: int = 0,
                   sampler_kwargs: Optional[dict] = None,
                   exact_shape: bool = False, max_seconds: float = 30.0) -> np.ndarray:
    """Enhance one file and write the result; returns the enhanced samples.

    The utterance is padded to a 64-frame bucket and trimmed after, as the
    JAX package does to bound its compiled shapes; ``exact_shape=True``
    runs it at its own length instead. A result that peaks above 1 is
    rescaled to peak at ``CLIP_SCALE``. A file longer than ``max_seconds``
    is enhanced chunk by chunk (:func:`chunk_starts`), each chunk with its
    own normalisation and clipping guard, and cross-faded back together
    (:func:`overlap_add`)."""
    audio, sr = read_wav(noisy_file)
    audio = audio[0]
    if sr != target_sr:
        audio = resample(audio, sr, target_sr)
    generator = torch.Generator(device=fdbm.device).manual_seed(seed)
    run = lambda a: _enhance_utterance(fdbm, a, generator, sampler_type, N,
                                       sampler_kwargs or {}, exact_shape)
    max_len = int(max_seconds * fdbm.cfg.sr) if math.isfinite(max_seconds) else len(audio)
    if len(audio) > max_len:
        hop = fdbm.cfg.hop_length
        chunk_len, starts = chunk_starts(len(audio), max_len, hop)
        x = overlap_add(len(audio), [(s, run(audio[s:s + chunk_len])) for s in starts],
                        OVERLAP_FRAMES * hop)
    else:
        x = run(audio)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    write_wav(output_file, x, target_sr)
    return x
