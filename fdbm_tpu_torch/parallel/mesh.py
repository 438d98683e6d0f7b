"""Data parallelism: a list of devices, batch shards and the data-parallel
train and valid steps.

Port of ``fdbm_tpu/parallel/mesh.py``. The JAX package jits its train step
over a 1-D ``data`` mesh: parameters replicated, the batch sharded, and the
gradient all-reduce inserted by XLA. The port keeps those semantics with
one process per device (``parallel/distributed.py``):

* each process computes the loss of its rows of the global batch and takes
  its gradients with ``torch.autograd.grad`` (``FDBM.train_step``'s way:
  ``DistributedDataParallel``'s hooks fire only on ``.backward()``, so it
  would reduce nothing here);
* the loss and the gradients go into one flat buffer, which one
  ``all_reduce`` averages over the processes: the gradient of the global
  batch's mean loss, the local batches being equal;
* every process then runs ``FDBM.apply_gradients`` unchanged on the same
  gradient (global-norm clip, Adam, EMA), so their states stay equal;
* the JAX package draws ``t`` and ``z`` for the global batch from one
  replicated key and shards them. Each process here draws the global
  batch's ``(t, z)`` from its generator, seeded alike on every process, in
  the order ``FDBM.loss_fn`` draws them on one process, and keeps its own
  rows: a step over N processes is the one-process step on the whole batch.

Without a process group the steps are ``FDBM.train_step`` /
``valid_step``. :func:`make_parallel_enhance` is batch-split serving in one
process (``infer.BucketedEnhancer(devices=...)``): a replica of the model a
device, the batch's draws made whole on the one generator, each replica
sampling its rows on a host thread, the results joined in row order.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from fdbm_tpu_torch.dsp import num_frames_for_length
from fdbm_tpu_torch.model import FDBM, TrainState
from fdbm_tpu_torch.parallel import distributed
from fdbm_tpu_torch.sampling import complex_normal_like


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of a data-parallel run: ``devices`` (default: every
    visible card), or the first ``n_devices`` of them. Asking for more than
    there are raises."""
    devs = [torch.device(d) for d in devices] if devices is not None else \
        [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if n_devices < 1 or len(devs) < n_devices:
            raise ValueError(f"Requested {n_devices} devices, have {len(devs)}")
        return devs[:n_devices]
    if not devs:
        raise ValueError("Requested the visible CUDA devices, have 0")
    return devs


def shard_batch(batch: Sequence, index: int, count: int) -> Tuple:
    """Rows ``[index * b, (index + 1) * b)`` of every array of a global
    batch of ``count * b`` rows: process ``index``'s share, the global batch
    being the processes' shares in process order."""
    rows = len(batch[0])
    if rows % count:
        raise ValueError(f"a batch of {rows} rows does not split over {count} processes")
    b = rows // count
    return tuple(a[index * b:(index + 1) * b] for a in batch)


def global_prior(fdbm: FDBM, rows: int, samples: int, generator: Optional[torch.Generator]
                 ) -> Optional[Tuple[Optional[torch.Tensor], torch.Tensor]]:
    """The ``(t, z)`` draw ``FDBM.loss_fn`` makes for a batch of ``rows``
    crops of ``samples`` samples, drawn as it draws them (``t`` then ``z``;
    fine-tuning draws only the sampler's prior ``z``, predictive mode
    nothing)."""
    cfg = fdbm.cfg
    if cfg.mode == "predictive":
        return None
    shape = (rows, 1, cfg.n_fft // 2 + 1, num_frames_for_length(samples, cfg.n_fft,
                                                               cfg.hop_length))
    t = None
    if cfg.mode == "generative":
        t = torch.rand(rows, generator=generator, device=fdbm.device, dtype=torch.float32) \
            * (cfg.T - cfg.t_eps) + cfg.t_eps
    z = complex_normal_like(torch.empty(shape, device=fdbm.device), generator)
    return t, z


def _local_prior(fdbm: FDBM, batch: Sequence[torch.Tensor],
                 generator: Optional[torch.Generator], prior=None):
    """This process's rows of the global draw (``prior``, else drawn)."""
    index, count = distributed.process_index(), distributed.process_count()
    rows, samples = batch[0].shape
    if prior is None:
        prior = global_prior(fdbm, rows * count, samples, generator)
    if prior is None:
        return None
    lo, hi = index * rows, (index + 1) * rows
    return tuple(None if p is None else p[lo:hi] for p in prior)


def all_reduce_mean_(flat: torch.Tensor) -> torch.Tensor:
    """Average ``flat`` over the processes, in place. NCCL averages in the
    collective (on one rank it still launches its reduce kernel); gloo sums
    and the sum is divided."""
    if dist.get_backend() == "nccl":
        dist.all_reduce(flat, op=dist.ReduceOp.AVG)
    else:
        dist.all_reduce(flat)
        flat.div_(dist.get_world_size())
    return flat


def data_parallel_grads(fdbm: FDBM, state: TrainState, batch: Sequence[torch.Tensor],
                        generator: Optional[torch.Generator] = None, prior=None
                        ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The global batch's mean loss and its gradients, from this process's
    rows ``batch``: the local loss on the local rows of the global draw
    (``prior``, the global batch's ``(t, z)``, replaces it), its gradients,
    then one all-reduce of the loss and the gradients."""
    loss = fdbm.loss_fn(batch, generator, _local_prior(fdbm, batch, generator, prior))
    params = list(state.params.values())
    grads = torch.autograd.grad(loss, params)
    flat = all_reduce_mean_(torch.cat([loss.detach().reshape(1)]
                                      + [g.reshape(-1) for g in grads]))
    sizes = [1] + [g.numel() for g in grads]
    parts = flat.split(sizes)
    return float(parts[0]), {name: part.view_as(p) for name, part, p in
                             zip(state.params, parts[1:], params)}


def data_parallel_train_step(fdbm: FDBM, state: TrainState, batch: Sequence[torch.Tensor],
                             generator: Optional[torch.Generator] = None,
                             prior=None) -> Dict[str, float]:
    """One step of the global batch whose rows ``batch`` this process holds:
    :func:`data_parallel_grads`, then ``FDBM.apply_gradients``. Without a
    process group, ``FDBM.train_step``."""
    if not dist.is_initialized():
        return fdbm.train_step(state, batch, generator, prior)
    loss, grads = data_parallel_grads(fdbm, state, batch, generator, prior)
    return {"train_loss": loss, **fdbm.apply_gradients(state, grads)}


def data_parallel_valid_step(fdbm: FDBM, state: TrainState, batch: Sequence[torch.Tensor],
                             generator: Optional[torch.Generator] = None) -> float:
    """The EMA weights' loss of this process's rows, on their rows of the
    global draw (no collective: the trainer weighs each process's losses by
    its real items and gathers them with the epoch's metrics). Without a
    process group, ``FDBM.valid_step``."""
    if not dist.is_initialized():
        return fdbm.valid_step(state, batch, generator)
    return fdbm.valid_step(state, batch, generator, _local_prior(fdbm, batch, generator))


def broadcast_train_state(fdbm: FDBM, state: TrainState) -> None:
    """Process 0's parameters, buffers, EMA weights and optimiser state on
    every process (after init, a resume or loaded weights)."""
    tensors = list(fdbm.dnn.state_dict().values()) + list(state.ema.values())
    for per_param in state.optimizer.state.values():
        tensors += [v for _, v in sorted(per_param.items()) if torch.is_tensor(v)]
    distributed.broadcast_(tensors)


def make_parallel_enhance(fdbm: FDBM, devices: Sequence, sampler_type: Optional[str] = None,
                          N: Optional[int] = None, pad_mode: str = "zero_pad", **sampler_kwargs
                          ) -> Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]:
    """``FDBM.enhance_batch`` with each batch's rows split over ``devices``
    (one replica of ``fdbm`` a device; ``fdbm`` itself serves the first
    slice where it sits on the first device). Returns ``enhance(y_audio,
    generator) -> [B, L]`` on ``fdbm``'s device: ``enhance_batch`` makes the
    spectrogram and the audio of the whole batch, and between them every
    draw of the sampler is made for the whole batch (``Bridge.draws``, the
    samplers' own draws, from ``generator``), the rows go in equal slices
    to the replicas, each samples its slice on a host thread (so their
    launches overlap), and the slices come back in row order. A batch whose
    rows do not divide over the devices raises, as do the samplers that
    couple a batch's rows."""
    devices = [torch.device(d) for d in devices]
    replicas = [fdbm if d == fdbm.device else fdbm.replica(d) for d in devices[:1]]
    replicas += [fdbm.replica(d) for d in devices[1:]]
    bridge = dataclasses.replace(fdbm.bridge, sampler_type=sampler_type or fdbm.bridge.sampler_type,
                                 N=N or fdbm.bridge.N)
    if fdbm.cfg.mode != "predictive":
        bridge.check_rows_apart(**sampler_kwargs)

    def sample_split(y: torch.Tensor, generator, sampler_type, N, **kwargs) -> torch.Tensor:
        rows = y.shape[0]
        if rows % len(replicas):
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{len(replicas)} devices")
        draws = {} if fdbm.cfg.mode == "predictive" else bridge.draws(y, generator, **kwargs)
        per = rows // len(replicas)

        def run(i: int) -> torch.Tensor:
            rep, rows_i = replicas[i], slice(i * per, (i + 1) * per)
            own = {k: (v[:, rows_i] if k == "noise" else v[rows_i]).to(rep.device)
                   for k, v in draws.items()}
            with torch.no_grad():  # grad mode is per thread
                out = rep.enhance_spec(y[rows_i].to(rep.device), None, sampler_type, N,
                                       **{**kwargs, **own})
            return out.to(fdbm.device)

        with ThreadPoolExecutor(max_workers=len(replicas)) as pool:
            return torch.cat(list(pool.map(run, range(len(replicas)))))

    def enhance(y_audio: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return fdbm.enhance_batch(y_audio, generator, bridge.sampler_type, bridge.N, pad_mode,
                                  sample_split, **sampler_kwargs)

    return enhance
