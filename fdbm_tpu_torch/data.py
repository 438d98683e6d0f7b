"""Host-side data pipeline: paired clean/noisy wavs -> batched audio crops.

Port of ``fdbm_tpu/data.py``: ``SpecsDataset`` decodes, crops (a random
start from the dataset's numpy generator in training, the centre otherwise)
or pads to ``(num_frames - 1) * hop_length`` samples, and normalises a pair
of wavs in one call of the native loader (``native/wavio.cc``, GIL-free
C++), and reads a file whose format that decoder does not take through
``utils/audio.py``, drawing its crop start as the JAX package's loader does
on each path, so that both packages give the same batches. ``BatchLoader``
prefetches batches on a thread, drops the last partial batch in training and
wrap-pads it with a 0/1 mask in validation. The STFT runs in the train step,
on the device.

Directory layout (format 'default'): {base_dir}/{subset}/clean|noisy/**/*.wav
with subset in train/valid/test.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from os.path import join
from typing import Iterator, List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from fdbm_tpu_torch.native import wavio
from fdbm_tpu_torch.parallel.distributed import process_count, process_index
from fdbm_tpu_torch.utils.audio import read_wav


@dataclasses.dataclass
class DataConfig:
    base_dir: str
    format: str = "default"
    batch_size: int = 8
    n_fft: int = 512
    hop_length: int = 256
    num_frames: int = 256
    window: str = "sqrthann"
    num_workers: int = 4
    dummy: bool = False
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5
    normalize: str = "noisy"
    transform_type: str = "exponent"
    num_data_per_epoch: Optional[int] = None

    @property
    def target_len(self) -> int:
        # the frame count of an STFT with center=True
        return (self.num_frames - 1) * self.hop_length


def _paired_files(base_dir: str, subset: str) -> Tuple[List[str], List[str]]:
    def find(kind: str) -> List[str]:
        return (sorted(glob(join(base_dir, subset, kind, "*.wav")))
                + sorted(glob(join(base_dir, subset, kind, "**", "*.wav"))))

    return find("clean"), find("noisy")


class SpecsDataset:
    """Paired dataset yielding normalised audio crops (x, y) [target_len].

    ``shard_by_process=True`` gives each process of the group its
    ``[index::count]`` slice of the epoch's file list (the same list on
    every process: the same seed draws it), as DDP's DistributedSampler
    does; ``effective_global_len`` is the list's length before the slice,
    from which the processes agree on their batch counts."""

    def __init__(self, cfg: DataConfig, subset: str, shuffle_spec: bool, seed: int = 0,
                 shard_by_process: bool = False):
        if cfg.format != "default":
            raise NotImplementedError(f"Directory format {cfg.format} unknown!")
        self.cfg = cfg
        self.subset = subset
        self.shuffle_spec = shuffle_spec
        self.shard_by_process = shard_by_process
        self.clean_files_all, self.noisy_files_all = _paired_files(cfg.base_dir, subset)
        if len(self.clean_files_all) != len(self.noisy_files_all):
            raise ValueError(f"{subset}: {len(self.clean_files_all)} clean vs "
                             f"{len(self.noisy_files_all)} noisy files")
        self.rng = np.random.default_rng(seed)
        # Items loaded by each path, and the loader's seconds on them (all
        # threads' sum).
        self.loaded = {"native": 0, "read_wav": 0, "seconds": 0.0}
        self._loaded_lock = threading.Lock()
        self.clean_files: List[str] = []
        self.noisy_files: List[str] = []
        self.global_len = 0
        self.sample_data_per_epoch()

    def sample_data_per_epoch(self) -> None:
        """Draw this epoch's ``num_data_per_epoch`` files (all if None),
        then keep this process's slice of them."""
        n = self.cfg.num_data_per_epoch
        if n is None:
            clean, noisy = list(self.clean_files_all), list(self.noisy_files_all)
        else:
            idx = self.rng.choice(len(self.clean_files_all), size=n, replace=False)
            clean = [self.clean_files_all[i] for i in idx]
            noisy = [self.noisy_files_all[i] for i in idx]
        self.global_len = len(clean)
        if self.shard_by_process:
            index, count = process_index(), process_count()
            clean, noisy = clean[index::count], noisy[index::count]
        self.clean_files, self.noisy_files = clean, noisy

    def __len__(self) -> int:
        n = len(self.clean_files)
        return max(1, n // 200) if self.cfg.dummy and n else n

    @property
    def effective_global_len(self) -> int:
        """The epoch's length before the process slice, with the dummy
        shrink: what every process counts its batches from."""
        n = self.global_len
        return max(1, n // 200) if self.cfg.dummy and n else n

    def load_item(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        t0 = time.perf_counter()
        target_len = self.cfg.target_len
        item = self._load_item_native(i, target_len)
        path = "native" if item is not None else "read_wav"
        if item is None:
            item = self._load_item_read_wav(i, target_len)
        with self._loaded_lock:
            self.loaded[path] += 1
            self.loaded["seconds"] += time.perf_counter() - t0
        return item

    def _load_item_native(self, i: int, target_len: int
                          ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The item through ``wavio.load_crop_pair_native``, None where the
        decoder does not take a file. The crop start is drawn only where the
        clean file is longer than ``target_len``, as the JAX package's
        native path draws it (``fdbm_tpu/data.py:163-190``)."""
        info = wavio.wav_info(self.clean_files[i])
        if info is None:
            return None
        current_len = info[2]
        if current_len > target_len and self.shuffle_spec:
            start = int(self.rng.uniform(0, current_len - target_len))
        else:
            start = -1  # the centre, or padding
        return wavio.load_crop_pair_native(self.clean_files[i], self.noisy_files[i],
                                           target_len, start, self.cfg.normalize)

    def _load_item_read_wav(self, i: int, target_len: int) -> Tuple[np.ndarray, np.ndarray]:
        x, _ = read_wav(self.clean_files[i])
        y, _ = read_wav(self.noisy_files[i])
        x, y = x[0], y[0]
        current_len = x.shape[-1]
        pad = max(target_len - current_len, 0)
        if pad == 0:
            if self.shuffle_spec:
                start = int(self.rng.uniform(0, current_len - target_len))
            else:
                start = int((current_len - target_len) / 2)
            x = x[start:start + target_len]
            y = y[start:start + target_len]
        else:
            x = np.pad(x, (pad // 2, pad // 2 + pad % 2))
            y = np.pad(y, (pad // 2, pad // 2 + pad % 2))
        normalize = self.cfg.normalize
        if normalize == "noisy":
            normfac = np.max(np.abs(y))
        elif normalize == "clean":
            normfac = np.max(np.abs(x))
        elif normalize == "not":
            normfac = 1.0
        elif normalize == "std":
            normfac = np.std(y)
        else:
            raise ValueError(f"Unknown normalize mode {normalize}")
        if normfac == 0:
            normfac = 1.0
        return (x / normfac).astype(np.float32), (y / normfac).astype(np.float32)


class BatchLoader:
    """Thread-prefetched batch iterator over a SpecsDataset.

    Yields (x, y) float32 arrays [B, target_len], with a [B] 0/1 mask when
    ``yield_mask`` (0 for wrap-padded duplicates). ``drop_last`` drops the
    last partial batch; otherwise it is wrap-padded to a full batch.
    ``num_batches`` fixes the batch count per epoch, truncating or
    wrap-padding (mask 0)."""

    def __init__(self, dataset: SpecsDataset, batch_size: int, shuffle: bool,
                 num_workers: int = 4, drop_last: bool = True, seed: int = 0,
                 yield_mask: bool = False, num_batches: Optional[int] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.yield_mask = yield_mask
        self.num_batches = num_batches
        self.epoch_rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.num_batches is not None:
            return self.num_batches
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _plan(self) -> List[Tuple[np.ndarray, int]]:
        """This epoch's (item indices, real items) per batch."""
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            self.epoch_rng.shuffle(order)
        batches = []
        for s in range(0, n, self.batch_size):
            idx = order[s:s + self.batch_size]
            n_real = len(idx)
            if n_real < self.batch_size:
                if self.drop_last and self.num_batches is None:
                    continue
                idx = np.concatenate([idx, np.resize(order, self.batch_size - n_real)])
            batches.append((idx, n_real))
        if self.num_batches is not None:
            batches = batches[:self.num_batches]
            if n == 0 and self.num_batches > 0:
                raise ValueError("num_batches > 0 requires a non-empty dataset")
            while len(batches) < self.num_batches:
                batches.append((np.resize(order, self.batch_size), 0))
        return batches

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        batches = self._plan()
        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def worker():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idx, n_real in batches:
                        if stop.is_set():
                            return
                        xs, ys = zip(*pool.map(self.ds.load_item, map(int, idx)))
                        batch = (np.stack(xs), np.stack(ys))
                        if self.yield_mask:
                            batch += ((np.arange(len(idx)) < n_real).astype(np.float32),)
                        q.put(batch)
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)
            finally:
                q.put(None)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                # The consumer's wait for the loader, a span of a profiler trace.
                with record_function("data.wait"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while th.is_alive():  # unblock a worker waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            th.join()


def make_loaders(cfg: DataConfig, seed: int = 0):
    """(train_loader, valid_loader) as the JAX package builds them."""
    train_set = SpecsDataset(cfg, "train", shuffle_spec=True, seed=seed)
    valid_set = SpecsDataset(cfg, "valid", shuffle_spec=False, seed=seed)
    train_loader = BatchLoader(train_set, cfg.batch_size, shuffle=True,
                               num_workers=cfg.num_workers, drop_last=True, seed=seed)
    valid_loader = BatchLoader(valid_set, cfg.batch_size, shuffle=False,
                               num_workers=cfg.num_workers, drop_last=False, seed=seed)
    return train_loader, valid_loader
