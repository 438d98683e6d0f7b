"""Host-side data pipeline: paired clean/noisy wavs -> batched audio crops.

Port of ``fdbm_tpu/data.py`` without its native loader: ``SpecsDataset``
reads a pair of wavs through ``utils/audio.py``, crops (a random start from
the dataset's numpy generator in training, the centre otherwise) or pads to
``(num_frames - 1) * hop_length`` samples, and normalises both by the
config's factor; ``BatchLoader`` prefetches batches on a thread, drops the
last partial batch in training and wrap-pads it with a 0/1 mask in
validation. The STFT runs in the train step, on the device.

Directory layout (format 'default'): {base_dir}/{subset}/clean|noisy/**/*.wav
with subset in train/valid/test.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from os.path import join
from typing import Iterator, List, Optional, Tuple

import numpy as np

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
    """Paired dataset yielding normalised audio crops (x, y) [target_len]."""

    def __init__(self, cfg: DataConfig, subset: str, shuffle_spec: bool, seed: int = 0):
        if cfg.format != "default":
            raise NotImplementedError(f"Directory format {cfg.format} unknown!")
        self.cfg = cfg
        self.subset = subset
        self.shuffle_spec = shuffle_spec
        self.clean_files_all, self.noisy_files_all = _paired_files(cfg.base_dir, subset)
        if len(self.clean_files_all) != len(self.noisy_files_all):
            raise ValueError(f"{subset}: {len(self.clean_files_all)} clean vs "
                             f"{len(self.noisy_files_all)} noisy files")
        self.rng = np.random.default_rng(seed)
        self.clean_files: List[str] = []
        self.noisy_files: List[str] = []
        self.sample_data_per_epoch()

    def sample_data_per_epoch(self) -> None:
        """Draw this epoch's ``num_data_per_epoch`` files (all if None)."""
        n = self.cfg.num_data_per_epoch
        if n is None:
            self.clean_files = list(self.clean_files_all)
            self.noisy_files = list(self.noisy_files_all)
            return
        idx = self.rng.choice(len(self.clean_files_all), size=n, replace=False)
        self.clean_files = [self.clean_files_all[i] for i in idx]
        self.noisy_files = [self.noisy_files_all[i] for i in idx]

    def __len__(self) -> int:
        n = len(self.clean_files)
        return max(1, n // 200) if self.cfg.dummy and n else n

    def load_item(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        target_len = self.cfg.target_len
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
