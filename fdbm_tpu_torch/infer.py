"""Single-utterance inference.

Port of ``fdbm_tpu/infer.py:enhance_single``: read, resample to 16 kHz,
normalise, pad to a 64-frame bucket, enhance, trim, renormalise with the
clipping guard, write. Folder serving (``BucketedEnhancer``,
``enhance_folder``) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from fdbm_tpu_torch.model import FDBM, normalisation
from fdbm_tpu_torch.utils.audio import read_wav, resample, write_wav

BUCKET_FRAMES = 64
# A result that peaks above 1 is rescaled to this peak (the reference
# single-file CLI uses 0.5, its folder CLI 0.95).
CLIP_SCALE = 0.5


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


def enhance_single(fdbm: FDBM, noisy_file: str, output_file: str,
                   sampler_type: Optional[str] = None, N: Optional[int] = None,
                   target_sr: int = 16000, seed: int = 0,
                   sampler_kwargs: Optional[dict] = None,
                   exact_shape: bool = False) -> np.ndarray:
    """Enhance one file and write the result; returns the enhanced samples.

    The utterance is padded to a 64-frame bucket and trimmed after, as the
    JAX package does to bound its compiled shapes; ``exact_shape=True``
    runs it at its own length instead. A result that peaks above 1 is
    rescaled to peak at ``CLIP_SCALE``."""
    audio, sr = read_wav(noisy_file)
    audio = audio[0]
    if sr != target_sr:
        audio = resample(audio, sr, target_sr)
    norm = normalisation(audio, fdbm.cfg.normalize)
    blen = bucket_length(len(audio), fdbm.cfg.hop_length, 1 if exact_shape else BUCKET_FRAMES)
    batch = torch.as_tensor(pad_to((audio / norm).astype(np.float32), blen)[None],
                            device=fdbm.device)
    generator = torch.Generator(device=fdbm.device).manual_seed(seed)
    enhanced = fdbm.enhance_batch(batch, generator, sampler_type=sampler_type, N=N,
                                  **(sampler_kwargs or {}))
    x = enhanced[0, :len(audio)].cpu().numpy() * norm
    peak = np.max(np.abs(x))
    if peak > 1.0:
        x = x / peak * CLIP_SCALE
    x = x.astype(np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    write_wav(output_file, x, target_sr)
    return x
