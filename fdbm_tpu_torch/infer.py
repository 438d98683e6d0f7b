"""Inference drivers: single utterance and the batched folder sweep.

Port of ``fdbm_tpu/infer.py``. :class:`BucketedEnhancer` enhances a list of
utterances in batches:

* utterances are normalised, reflect-padded to a length bucket, enhanced
  in batches of ``batch_size`` rows and trimmed; a result that peaks above
  1 is rescaled to ``clip_scale`` (0.95 for folders, 0.5 for single files,
  as the reference CLIs do);
* :meth:`~BucketedEnhancer.plan` packs the utterances in descending length
  into consecutive batches (each at its longest member's bucket), and the
  under-filled remainder batch runs at the covering power of two;
* with ``chunk_seconds`` set (the folder default, 4.096 s, the training
  crop), every utterance longer than 3/2 of it is cut into equal chunks on
  the 16-frame grid (:meth:`~BucketedEnhancer._chunk_plan`), all chunks of
  all files go through one batched sweep, and each file is cross-faded back
  together over 16 frames; otherwise a file longer than ``max_seconds``
  (30 s) is enhanced in overlapping chunks of its own.

The sweep is a pipeline: a batch's sampler is enqueued on the current
stream and its output copied to pinned host memory behind it; the host reads
a batch back only when ``FDBM_TPU_SERVE_DEPTH`` batches (default 3) are in
flight, so the card works on queued batches while the host builds the next
one. ``FDBM_TPU_SERVE_TRACE=1`` prints one line a batch, the JAX package's
``[serve] blen=... n=... gap=... build+h2d=... retire=...`` (seconds: the
host's gap since the last line, building and enqueueing the batch, and
reading back the oldest). PyTorch compiles
nothing per shape, so ``prewarm`` is the one-time build of the CUDA kernels.
Randomness comes from one ``torch.Generator`` on the device.
:func:`enhance_folder` serves a folder (this process's share of it in a
process group), :func:`enhance_single` one file. With ``devices`` every
batch is split over several devices (:class:`BucketedEnhancer`).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fdbm_tpu_torch.model import FDBM, normalisation
from fdbm_tpu_torch.ops import _build
from fdbm_tpu_torch.parallel import distributed
from fdbm_tpu_torch.parallel.mesh import make_parallel_enhance
from fdbm_tpu_torch.utils.audio import read_wav, resample, write_wav

BUCKET_FRAMES = 64
# A result that peaks above 1 is rescaled to this peak (the reference
# single-file CLI uses 0.5, its folder CLI 0.95).
SINGLE_CLIP_SCALE = 0.5
FOLDER_CLIP_SCALE = 0.95
# Cross-fade between the chunks of a long file, in STFT frames.
OVERLAP_FRAMES = 16
# Batches in flight before the oldest is read back, unless
# FDBM_TPU_SERVE_DEPTH says otherwise (the JAX package's default depth).
SERVE_DEPTH = 3


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


def shard_files(files: Sequence[str], process_index: int, process_count: int) -> List[str]:
    """Static split of a file list across processes."""
    return list(files[process_index::process_count])


@dataclasses.dataclass
class EnhanceStats:
    files: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    # The kernel build, included in wall_seconds; steady_throughput leaves it out.
    prewarm_seconds: float = 0.0
    failures: int = 0
    # Phases, all included in wall_seconds: input decode, the enhance loop,
    # the final drain of the output writes.
    read_seconds: float = 0.0
    enhance_seconds: float = 0.0
    write_drain_seconds: float = 0.0

    @property
    def throughput(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def steady_throughput(self) -> float:
        wall = self.wall_seconds - self.prewarm_seconds
        return self.audio_seconds / wall if wall > 0 else 0.0


class BucketedEnhancer:
    """Batched, bucketed audio -> audio enhancement on ``fdbm``'s device."""

    # Pooled serving's fine bucket quantum, in frames: chunk lengths are
    # planned on this grid (_chunk_plan), so chunked rows run at their own
    # length with no bucket padding; whole files inside the sweet band
    # (>= 2/3 of the target) are bucketed on it too.
    _FINE_FRAMES = 16

    def __init__(self, fdbm: FDBM, sampler_type: Optional[str] = None, N: Optional[int] = None,
                 batch_size: int = 8, bucket_frames_multiple: int = BUCKET_FRAMES,
                 sampler_kwargs: Optional[dict] = None, chunk_seconds: Optional[float] = None,
                 devices: Optional[Sequence] = None):
        """``chunk_seconds``: pooled chunk serving (see the module note);
        None serves whole utterances (up to ``max_seconds``). ``devices``:
        batch-split serving, every batch's rows split evenly over these
        devices, one replica of the model each
        (``parallel.mesh.make_parallel_enhance``; the JAX package's
        ``mesh``): ``batch_size`` must divide by their count, and every
        batch runs at the full batch size."""
        self.fdbm = fdbm
        self.sampler_type = sampler_type
        self.N = N
        self.batch_size = batch_size
        self.bucket_multiple = max(1, bucket_frames_multiple)
        self.sampler_kwargs = sampler_kwargs or {}
        self.chunk_seconds = chunk_seconds
        self.split = None
        if devices:
            if batch_size % len(devices):
                raise ValueError(f"batch_size {batch_size} must divide by the {len(devices)} "
                                 "devices of batch-split serving")
            self.split = make_parallel_enhance(fdbm, devices, sampler_type, N, self._pad_mode(),
                                               **self.sampler_kwargs)

    def _pad_mode(self) -> str:
        """NCSN++ serving pads its frames by reflection (reference
        infer_single.py:64-69, infer_folder.py:83-88)."""
        return "reflection" if self.fdbm.cfg.backbone.startswith("ncsnpp") else "zero_pad"

    # -- plan -----------------------------------------------------------------

    def _bucket_length(self, n_samples: int) -> int:
        """The bucket of an utterance: the next multiple of bucket_multiple
        frames, or of the fine 16 frames in pooled serving's sweet band."""
        frames = self.bucket_multiple
        if self.chunk_seconds:
            target = int(self.chunk_seconds * self.fdbm.cfg.sr)
            if n_samples * 3 >= target * 2:  # sweet band: >= 2/3 target
                frames = min(frames, self._FINE_FRAMES)
        return bucket_length(n_samples, self.fdbm.cfg.hop_length, frames)

    def _dispatch_width(self, n_rows: int) -> int:
        """Rows a batch of ``n_rows`` utterances runs at: the batch size, or
        for the under-filled remainder the covering power of two (batch-split
        serving: always the batch size)."""
        if self.split is not None or n_rows >= self.batch_size:
            return self.batch_size
        return max(1, 1 << (n_rows - 1).bit_length())

    def plan(self, lengths: Sequence[int]) -> List[Tuple[int, List[int]]]:
        """Sorted packing: utterances in descending length, in consecutive
        groups of ``batch_size``, each at its longest member's bucket; the
        only partial group is the remainder, on the shortest utterances."""
        order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
        return [(self._bucket_length(lengths[order[s]]), order[s:s + self.batch_size])
                for s in range(0, len(order), self.batch_size)]

    def _chunk_plan(self, n_samples: int) -> Tuple[int, List[int]]:
        """``(chunk_len, starts)`` of pooled chunking: chunk lengths on the
        16-frame grid, the count k that minimises the frames computed,
        ``k * chunk_len``, with chunks in the sweet band (2/3 to 3/2 of the
        target), ties to fewer chunks; overlaps of at least 16 frames
        (``chunk_len >= (n + (k-1)*overlap) / k``), evenly spaced starts.
        A file of at most 3/2 target is one chunk. Where the plan would put
        a chunk below the band (a target tiny against the overlap), its
        length is raised to the band's first grid length, and where no
        count fits the file at all, the file is one chunk: chunks always
        run at their own length on the grid."""
        cfg = self.fdbm.cfg
        target = int(self.chunk_seconds * cfg.sr)
        overlap = OVERLAP_FRAMES * cfg.hop_length
        fine = self._FINE_FRAMES * cfg.hop_length
        lo = (2 * target) // 3
        hi = (3 * target + 1) // 2
        if n_samples <= max(hi, fine):
            return n_samples, [0]
        band = -(-2 * target // 3)  # the sweet band's first length, on the grid below
        band = -(-band // fine) * fine
        best: Optional[Tuple[int, int, int]] = None  # (cost, k, chunk_len)
        k_min = max(2, -(-n_samples // hi))
        k_max = max(k_min, n_samples // max(lo, fine))
        for k in range(k_min, k_max + 1):
            chunk_len = -(-(n_samples + (k - 1) * overlap) // k)
            chunk_len = -(-chunk_len // fine) * fine
            if chunk_len > n_samples:
                continue
            if best is not None and chunk_len < lo:
                break  # below the band and a feasible plan exists
            chunk_len = min(n_samples, max(chunk_len, band))
            cost = k * chunk_len
            if best is None or cost < best[0]:
                best = (cost, k, chunk_len)
        if best is None:
            return n_samples, [0]
        _, k, chunk_len = best
        return chunk_len, [round(j * (n_samples - chunk_len) / (k - 1)) for j in range(k)]

    # -- prewarm --------------------------------------------------------------

    def prewarm(self) -> float:
        """Build the CUDA kernels (once per checkout) if the model is on a
        card and runs them (NCSN++ runs none); returns the seconds it took."""
        t0 = time.perf_counter()
        if self.fdbm.device.type == "cuda" and not self.fdbm.cfg.backbone.startswith("ncsnpp"):
            _build.build_all()
        return time.perf_counter() - t0

    # -- enhance --------------------------------------------------------------

    @staticmethod
    def _normalise(y: np.ndarray, mode: str) -> Tuple[np.ndarray, float]:
        norm = normalisation(y, mode)
        return (y / norm).astype(np.float32), norm

    def enhance_many(self, audios: Sequence[np.ndarray], generator: torch.Generator,
                     clip_scale: float = FOLDER_CLIP_SCALE, max_seconds: float = 30.0,
                     _pooled: bool = True) -> List[np.ndarray]:
        """Enhance 1-D float32 utterances; returns them in order. With
        ``chunk_seconds`` set every utterance goes through pooled chunk
        serving; otherwise one longer than ``max_seconds`` is enhanced in
        overlapping chunks with a cross-fade."""
        if self.chunk_seconds and _pooled:
            return self._enhance_pooled(audios, generator, clip_scale)
        cfg = self.fdbm.cfg
        max_len = (int(max_seconds * cfg.sr) if math.isfinite(max_seconds)
                   else max(len(a) for a in audios) + 1)
        long_idx = [i for i, a in enumerate(audios) if len(a) > max_len]
        if long_idx:
            out_all: List[Optional[np.ndarray]] = [None] * len(audios)
            short = [i for i in range(len(audios)) if i not in set(long_idx)]
            if short:
                shorts = self.enhance_many([audios[i] for i in short], generator, clip_scale,
                                           max_seconds=math.inf)
                for j, i in enumerate(short):
                    out_all[i] = shorts[j]
            for i in long_idx:
                out_all[i] = self._enhance_long(audios[i], generator, clip_scale, max_len)
            return out_all  # type: ignore[return-value]

        out: List[Optional[np.ndarray]] = [None] * len(audios)

        def dispatch(blen: int, rows: List[int]):
            """Build a batch on the host and enqueue its enhancement, then
            the copy of its output to pinned host memory, on the stream."""
            width = self._dispatch_width(len(rows))
            batch = np.zeros((width, blen), np.float32)
            norms = np.ones(width, np.float32)
            for j, i in enumerate(rows):
                a, norms[j] = self._normalise(audios[i], cfg.normalize)
                batch[j] = pad_to(a, blen)
            dev = self.fdbm.device
            y = torch.from_numpy(batch)
            if dev.type == "cuda":
                y = y.pin_memory().to(dev, non_blocking=True)
            if self.split is not None:
                enhanced = self.split(y, generator)
            else:
                enhanced = self.fdbm.enhance_batch(y, generator, sampler_type=self.sampler_type,
                                                   N=self.N, pad_mode=self._pad_mode(),
                                                   **self.sampler_kwargs)
            done = None
            if dev.type == "cuda":
                host = torch.empty(enhanced.shape, dtype=enhanced.dtype, pin_memory=True)
                host.copy_(enhanced, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                enhanced = host
            return enhanced, done, norms, rows

        def retire(pending) -> None:
            """Wait for a batch's copy and post-process it on the host."""
            enhanced, done, norms, rows = pending
            if done is not None:
                done.synchronize()
            enhanced = enhanced.numpy()
            for j, i in enumerate(rows):
                x = enhanced[j, :len(audios[i])] * norms[j]
                peak = np.max(np.abs(x))
                if peak > 1.0:
                    x = x / peak * clip_scale
                out[i] = x.astype(np.float32)

        depth = max(1, int(os.environ.get("FDBM_TPU_SERVE_DEPTH", SERVE_DEPTH)))
        trace = os.environ.get("FDBM_TPU_SERVE_TRACE") == "1"
        in_flight: deque = deque()
        t_prev = time.perf_counter()
        for blen, rows in self.plan([len(a) for a in audios]):
            t0 = time.perf_counter()
            in_flight.append(dispatch(blen, rows))
            t1 = t2 = time.perf_counter()
            if len(in_flight) >= depth:
                retire(in_flight.popleft())
                t2 = time.perf_counter()
            if trace:
                print(f"[serve] blen={blen} n={len(rows)} gap={t0 - t_prev:.2f} "
                      f"build+h2d={t1 - t0:.2f} retire={t2 - t1:.2f}", flush=True)
            t_prev = t2
        while in_flight:
            retire(in_flight.popleft())
        return out  # type: ignore[return-value]

    def _enhance_long(self, audio: np.ndarray, generator: torch.Generator, clip_scale: float,
                      max_len: int) -> np.ndarray:
        """Overlapping chunks of at most ``max_len`` samples, cross-faded."""
        hop = self.fdbm.cfg.hop_length
        chunk_len, starts = chunk_starts(len(audio), max_len, hop)
        enhanced = self.enhance_many([audio[s:s + chunk_len] for s in starts], generator,
                                     clip_scale, max_seconds=math.inf)
        return overlap_add(len(audio), list(zip(starts, enhanced)), OVERLAP_FRAMES * hop)

    def _enhance_pooled(self, audios: Sequence[np.ndarray], generator: torch.Generator,
                        clip_scale: float) -> List[np.ndarray]:
        """Pooled chunk serving: the chunks of every file (a short file is
        one chunk) in one batched sweep, then each file cross-faded back."""
        pieces: List[np.ndarray] = []
        owners: List[Tuple[int, int]] = []  # (file, start)
        for i, a in enumerate(audios):
            chunk_len, starts = self._chunk_plan(len(a))
            for s in starts:
                pieces.append(a[s:s + chunk_len])
                owners.append((i, s))
        enhanced = self.enhance_many(pieces, generator, clip_scale, max_seconds=math.inf,
                                     _pooled=False)
        per_file: List[List[Tuple[int, np.ndarray]]] = [[] for _ in audios]
        for (i, s), e in zip(owners, enhanced):
            per_file[i].append((s, e))
        ramp = OVERLAP_FRAMES * self.fdbm.cfg.hop_length
        return [segs[0][1] if len(segs) == 1 else overlap_add(len(a), segs, ramp)
                for a, segs in zip(audios, per_file)]


def _read(path: str, target_sr: int) -> np.ndarray:
    audio, sr = read_wav(path)
    audio = audio[0]
    return resample(audio, sr, target_sr) if sr != target_sr else audio


def enhance_folder(fdbm: FDBM, test_dir: str, enhanced_dir: str,
                   sampler_type: Optional[str] = None, N: Optional[int] = None,
                   batch_size: int = 8, keep_structure: bool = True, target_sr: int = 16000,
                   seed: int = 0, process_index: Optional[int] = None,
                   process_count: Optional[int] = None, sampler_kwargs: Optional[dict] = None,
                   progress: bool = True, chunk_seconds: Optional[float] = 4.096,
                   devices: Optional[Sequence] = None) -> EnhanceStats:
    """Enhance every wav/flac under ``test_dir`` into ``enhanced_dir`` (this
    process's share of the sorted file list: ``process_index`` and
    ``process_count``, by default this process's rank and the size of its
    group, ``parallel.distributed``). A file that fails to read, a batch
    group that fails to enhance, a NaN output and a failed write are each
    counted in ``failures`` and skipped. ``chunk_seconds``: pooled chunk
    serving (see the module note); None or 0 serves whole utterances.
    ``devices``: batch-split serving (:class:`BucketedEnhancer`)."""
    files = sorted(glob(os.path.join(test_dir, "**", "*.wav"), recursive=True)
                   + glob(os.path.join(test_dir, "**", "*.flac"), recursive=True))
    process_index = distributed.process_index() if process_index is None else process_index
    process_count = distributed.process_count() if process_count is None else process_count
    files = shard_files(files, process_index, process_count)
    enhancer = BucketedEnhancer(fdbm, sampler_type=sampler_type, N=N, batch_size=batch_size,
                                sampler_kwargs=sampler_kwargs, chunk_seconds=chunk_seconds or None,
                                devices=devices)
    generator = torch.Generator(device=fdbm.device).manual_seed(seed + process_index)
    stats = EnhanceStats()
    t_start = time.perf_counter()

    todo: List[Tuple[str, np.ndarray]] = []
    for path in files:
        try:
            todo.append((path, _read(path, target_sr)))
        except Exception as e:  # noqa: BLE001 - skip and count, as the reference does
            print(f"[skip] {path}: {e}", file=sys.stderr)
            stats.failures += 1
    stats.read_seconds = time.perf_counter() - t_start
    if todo:
        stats.prewarm_seconds = enhancer.prewarm()

    # Descending lengths, in groups of 16 batches: each group's plan is a
    # slice of the folder's plan.
    order = sorted(range(len(todo)), key=lambda i: -len(todo[i][1]))
    group = batch_size * 16

    def write_one(out_path: str, x_hat: np.ndarray) -> float:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        write_wav(out_path, x_hat, target_sr)
        return len(x_hat) / target_sr

    writes = []
    t_enh = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as writer:
        for s in range(0, len(order), group):
            idxs = order[s:s + group]
            try:
                enhanced = enhancer.enhance_many([todo[i][1] for i in idxs], generator)
            except Exception as e:  # noqa: BLE001 - skip and count the group's files
                print(f"[skip group] {e!r}", file=sys.stderr)
                stats.failures += len(idxs)
                continue
            for i, x_hat in zip(idxs, enhanced):
                path = todo[i][0]
                rel = os.path.relpath(path, test_dir) if keep_structure else os.path.basename(path)
                if np.isnan(x_hat).any():
                    print(f"[skip] {path}: NaN output", file=sys.stderr)
                    stats.failures += 1
                    continue
                out_path = os.path.join(enhanced_dir, os.path.splitext(rel)[0] + ".wav")
                writes.append((path, writer.submit(write_one, out_path, x_hat)))
            if progress:
                print(f"enhanced {min(s + group, len(order))}/{len(order)} files", flush=True)
        stats.enhance_seconds = time.perf_counter() - t_enh
        t_drain = time.perf_counter()
        for path, fut in writes:
            try:
                stats.audio_seconds += fut.result()
                stats.files += 1
            except Exception as e:  # noqa: BLE001 - count a failed write
                print(f"[skip] {path}: write failed: {e}", file=sys.stderr)
                stats.failures += 1
        stats.write_drain_seconds = time.perf_counter() - t_drain
    stats.wall_seconds = time.perf_counter() - t_start
    return stats


def enhance_single(fdbm: FDBM, noisy_file: str, output_file: str,
                   sampler_type: Optional[str] = None, N: Optional[int] = None,
                   target_sr: int = 16000, seed: int = 0,
                   sampler_kwargs: Optional[dict] = None,
                   exact_shape: bool = False, max_seconds: float = 30.0) -> np.ndarray:
    """Enhance one file and write the result; returns the enhanced samples.

    The utterance is padded to a 64-frame bucket and trimmed after, as the
    JAX package does to bound its compiled shapes; ``exact_shape=True``
    runs it at its own length (whole hops) instead. A result that peaks
    above 1 is rescaled to peak at ``SINGLE_CLIP_SCALE``. A file longer than
    ``max_seconds`` is enhanced chunk by chunk (:func:`chunk_starts`), each
    chunk with its own normalisation and clipping guard, and cross-faded
    back together (:func:`overlap_add`)."""
    audio = _read(noisy_file, target_sr)
    enhancer = BucketedEnhancer(fdbm, sampler_type=sampler_type, N=N, batch_size=1,
                                bucket_frames_multiple=1 if exact_shape else BUCKET_FRAMES,
                                sampler_kwargs=sampler_kwargs)
    generator = torch.Generator(device=fdbm.device).manual_seed(seed)
    x = enhancer.enhance_many([audio], generator, clip_scale=SINGLE_CLIP_SCALE,
                              max_seconds=max_seconds)[0]
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    write_wav(output_file, x, target_sr)
    return x
