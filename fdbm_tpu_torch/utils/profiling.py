"""Tracing and timing: the port's counterpart of ``fdbm_tpu/utils/profiling.py``.

* ``trace(log_dir)`` — a ``torch.profiler`` context over the host and, on a
  machine with a card, the card's kernels, written as a Chrome trace (open it
  in ``chrome://tracing`` or Perfetto) under ``log_dir``; a falsy
  ``log_dir`` makes it a no-op.
* ``StepTimer`` — wall-clock step timing with EMA smoothing, the JAX
  package's ``steps_per_sec``.
* ``flops_estimate`` — the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``: the counterpart of the JAX
  package's XLA cost analysis.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], name: str = "trace.json",
          device: Optional[torch.device] = None) -> Iterator[Optional[object]]:
    """Profile the block and write ``<log_dir>/<name>``, a Chrome trace;
    yields the ``torch.profiler.profile`` (None when ``log_dir`` is falsy,
    and then nothing is traced). The card's activity is recorded where
    CUDA is available and ``device`` is a CUDA device or None; the card is
    synchronised before the trace stops, so its queued kernels are in it. A
    profiler that fails to start raises."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda")
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, name))


class StepTimer:
    """EMA-smoothed step timing: ``tick()`` once a step; ``ema`` is the
    smoothed seconds a step (None before the second tick)."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self._last: Optional[float] = None
        self.ema: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else self.decay * self.ema + (1 - self.decay) * dt
        self._last = now
        return self.ema

    @property
    def steps_per_sec(self) -> Optional[float]:
        return (1.0 / self.ema) if self.ema else None


def flops_estimate(fn: Callable, *args) -> int:
    """The FLOPs of ``fn(*args)`` (its backward too, where ``fn`` runs one),
    counted by ``FlopCounterMode``: two a multiply-add of the products and
    convolutions, the ops that it counts; elementwise ops count nothing.
    The port's CUDA kernels are opaque to the counter (a launch through
    ctypes is no PyTorch op), so count a call on the plain route, which
    computes the same function on PyTorch ops: a backbone built with
    ``use_kernels=False``, or CPU tensors. ``fn`` runs once."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()
