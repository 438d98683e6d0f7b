"""Training CLI and loop of the port.

    python -m fdbm_tpu_torch.train -C configs/config.yaml [key=value ...] \
        [--device cpu] [-D N] [--max_steps N] [--max_epochs N] [--seed S] \
        [--resume RUN_DIR] [--ckpt RUN_OR_CHECKPOINT_DIR] \
        [--profile_steps START END] [--nolog]

Port of ``fdbm_tpu/train.py`` and the root ``train.py``: train steps over
``SpecsDataset`` crops, scalars every ``log_every_n_steps`` steps to
``<run>/metrics.jsonl`` (and as TensorBoard scalars in ``<run>`` where
``torch.utils.tensorboard`` imports), then per epoch the valid loss under the EMA weights
(the mean of the batch losses weighted by their real items), the evaluation
of the first ``num_eval_files`` valid files (enhanced whole under the EMA
weights, scored by SI-SDR, PESQ and ESTOI, the first three written to
``<run>/valid_samples``) and the five checkpoint slots. ``--resume``
continues a run directory from its ``last`` slot; ``--ckpt`` starts a new
run from another run's ``last`` slot. The model's initial weights come
from ``--seed``. Runs on the GPU unless ``--device cpu`` is given.

Data parallel (``parallel/``): ``-D N`` starts N processes on this machine
(process r on ``cuda:r`` over NCCL; with ``--device cpu`` on the CPU over
gloo); under ``torchrun`` each process is its rank (``cuda:LOCAL_RANK``).
Each process loads its ``[rank::N]`` share of the files and ``batch_size /
N`` rows of each global batch; a step averages the gradients over the
processes (``mesh.data_parallel_train_step``); the evaluation is sharded
by file and its metrics gathered over ``VALID_METRIC_SCHEMA``. Process 0
alone writes the run directory: checkpoints, ``metrics.jsonl``, the sample
wavs, the code snapshot (``<run>/code``: the root ``*.py``/``*.yaml`` and
``fdbm_tpu_torch/``; ``--nolog`` skips it) and the ``--profile_steps``
trace (``utils.profiling.trace`` over train steps START..END, counted from
1, a Chrome trace under ``<run>/profile``). ``compute_dtype=bfloat16``
trains in bf16 (``model.py``); parameters, Adam, the EMA and the
checkpoints stay fp32.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from fdbm_tpu_torch.checkpoint import CheckpointManager
from fdbm_tpu_torch.config import load_config, parse_cli_overrides
from fdbm_tpu_torch.data import BatchLoader, DataConfig, SpecsDataset
from fdbm_tpu_torch.infer import BucketedEnhancer
from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState
from fdbm_tpu_torch.parallel import distributed
from fdbm_tpu_torch.parallel.distributed import (VALID_METRIC_SCHEMA, all_gather_host_metrics,
                                                 process_count, process_index)
from fdbm_tpu_torch.parallel.mesh import (broadcast_train_state, data_parallel_train_step,
                                          data_parallel_valid_step, make_mesh)
from fdbm_tpu_torch.utils import metrics as metrics_lib
from fdbm_tpu_torch.utils.audio import read_wav, resample, write_wav
from fdbm_tpu_torch.utils.profiling import trace


def snapshot_code(log_dir: str) -> None:
    """Copy the root ``*.py``/``*.yaml`` files and the port's package into
    ``<log_dir>/code`` (``fdbm_tpu/train.py:snapshot_code``)."""
    code_dir = os.path.join(log_dir, "code")
    os.makedirs(code_dir, exist_ok=True)
    package = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(package)
    for name in os.listdir(repo):
        src = os.path.join(repo, name)
        if name.endswith((".py", ".yaml")) and os.path.isfile(src):
            shutil.copy2(src, code_dir)
    shutil.copytree(package, os.path.join(code_dir, os.path.basename(package)),
                    dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__", "_build"))


class ProfileWindow:
    """``utils.profiling.trace`` over train steps ``start``..``end`` (counted
    from 1: it starts before step ``start`` and stops after step ``end``, as
    ``fdbm_tpu/train.py`` traces), written as a Chrome trace to
    ``<log_dir>/profile/steps_<start>-<end>.json``."""

    def __init__(self, steps: Tuple[int, int], log_dir: str, device: torch.device):
        self.start, self.end = steps
        self.dir = os.path.join(log_dir, "profile")
        self.name = f"steps_{self.start}-{self.end}.json"
        self.device = device
        self._open: Optional[contextlib.ExitStack] = None

    def before_step(self, step: int) -> None:
        """Called with the steps taken so far, before the next."""
        if step + 1 == self.start:
            self._open = contextlib.ExitStack()
            self._open.enter_context(trace(self.dir, self.name, self.device))

    def after_step(self, step: int) -> None:
        if step == self.end:
            self.stop()

    def stop(self) -> None:
        """End the window (also where training ends inside it) and write it."""
        if self._open is not None:
            self._open.close()
            self._open = None


class MetricsLogger:
    """Scalars as JSON lines in ``<log_dir>/metrics.jsonl`` and, where
    ``torch.utils.tensorboard`` imports, as TensorBoard scalars in
    ``log_dir`` (``fdbm_tpu/train.py:MetricsLogger``)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package: the JSON lines alone
            self.tb = None
        else:
            self.tb = SummaryWriter(log_dir=log_dir)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)
            self.tb.flush()

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


@contextlib.contextmanager
def backbone_weights(dnn: torch.nn.Module,
                     params: Optional[Dict[str, torch.Tensor]]) -> Iterator[None]:
    """Serve ``dnn`` with ``params`` (e.g. the EMA weights) in place of its
    own for the block, then put its own back."""
    if params is None:
        yield
        return
    own = {k: v.detach().clone() for k, v in dnn.state_dict().items() if k in params}
    with torch.no_grad():
        dnn.load_state_dict(params, strict=False)
    try:
        yield
    finally:
        with torch.no_grad():
            dnn.load_state_dict(own, strict=False)


def evaluate_files(fdbm: FDBM, params: Optional[Dict[str, torch.Tensor]],
                   valid_set: SpecsDataset, num_eval_files: int,
                   generator: Optional[torch.Generator] = None, sample_dir: Optional[str] = None,
                   epoch: int = 0, sampler_batch: int = 4
                   ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """Enhance the first ``num_eval_files`` valid files whole under
    ``params`` (the EMA weights; None: the backbone's own) through
    ``BucketedEnhancer`` at the config's sampler, ``4 * sampler_batch``
    files at a time, and score SI-SDR, PESQ (``metrics.pesq_wb`` on the
    model's device) and ESTOI on the common length; a NaN output is
    skipped. In a process group each process takes its ``[rank::count]``
    share of those files. The first three files' outputs (of process 0's
    share) go to ``sample_dir`` as ``<name>_epoch<epoch>_enh.wav``, at epoch
    0 also their noisy and clean inputs. Returns this process's ``(means,
    counts)`` per metric, as ``fdbm_tpu/train.py:evaluate_files`` does,
    for ``all_gather_host_metrics``."""
    index, count = process_index(), process_count()
    clean_files = valid_set.clean_files_all[:num_eval_files][index::count]
    noisy_files = valid_set.noisy_files_all[:num_eval_files][index::count]
    if not clean_files:
        return {}, {}
    if generator is None:
        generator = torch.Generator(device=fdbm.device).manual_seed(0)
    enhancer = BucketedEnhancer(fdbm, batch_size=sampler_batch)
    vals: Dict[str, list] = {"si_sdr": [], "pesq": [], "estoi": []}
    chunk = max(1, 4 * sampler_batch)
    for s in range(0, len(clean_files), chunk):
        audios, cleans = [], []
        for cf, nf in zip(clean_files[s:s + chunk], noisy_files[s:s + chunk]):
            (x, sr_x), (y, sr_y) = read_wav(cf), read_wav(nf)
            if sr_x != sr_y:
                raise ValueError(f"sample rates of {cf} ({sr_x}) and {nf} ({sr_y}) differ")
            x, y = x[0], y[0]
            if sr_x != 16000:
                x, y = resample(x, sr_x, 16000), resample(y, sr_y, 16000)
            cleans.append(x)
            audios.append(y)
        with backbone_weights(fdbm.dnn, params):
            enhanced = enhancer.enhance_many(audios, generator)
        for j, (x, x_hat) in enumerate(zip(cleans, enhanced)):
            i = s + j
            if np.isnan(x_hat).any():
                continue
            n = min(len(x), len(x_hat))
            vals["si_sdr"].append(metrics_lib.si_sdr(x[:n], x_hat[:n]))
            p = metrics_lib.pesq_wb(16000, x[:n], x_hat[:n], fdbm.device)
            if p is not None:
                vals["pesq"].append(p)
            e = metrics_lib.estoi(x[:n], x_hat[:n], 16000)
            if np.isfinite(e):
                vals["estoi"].append(e)
            if sample_dir and i < 3 and index == 0:
                base = os.path.splitext(os.path.basename(clean_files[i]))[0]
                write_wav(os.path.join(sample_dir, f"{base}_epoch{epoch:03d}_enh.wav"), x_hat,
                          16000)
                if epoch == 0:
                    write_wav(os.path.join(sample_dir, f"{base}_noisy.wav"), audios[j], 16000)
                    write_wav(os.path.join(sample_dir, f"{base}_clean.wav"), x, 16000)
    means = {k: float(np.mean(v)) for k, v in vals.items() if v}
    return means, {k: len(v) for k, v in vals.items() if v}


class Trainer:
    def __init__(self, fdbm: FDBM, data_cfg: DataConfig, log_dir: str,
                 max_steps: int = 1_000_000, max_epochs: int = 10_000,
                 num_eval_files: int = 20, save_ckpt_interval: int = 20000,
                 log_every_n_steps: int = 10, seed: int = 0,
                 config_blob: Optional[Dict[str, Any]] = None, snapshot: bool = True,
                 profile_steps: Optional[Tuple[int, int]] = None):
        """In a process group every process builds one; process 0 alone
        writes ``log_dir`` (and takes the ``profile_steps`` trace)."""
        self.fdbm = fdbm
        self.data_cfg = data_cfg
        self.log_dir = log_dir
        self.max_steps = max_steps
        self.max_epochs = max_epochs
        self.num_eval_files = num_eval_files
        self.log_every = log_every_n_steps
        self.seed = seed
        self.rank, self.world = process_index(), process_count()
        self.sample_dir = os.path.join(log_dir, "valid_samples")
        self.ckpt_dir = os.path.join(log_dir, "checkpoints")
        self.ckpt = self.logger = self.profile = None
        if self.rank == 0:
            os.makedirs(log_dir, exist_ok=True)
            if snapshot:
                snapshot_code(log_dir)
            self.ckpt = CheckpointManager(self.ckpt_dir, save_interval=save_ckpt_interval,
                                          config=config_blob)
            self.logger = MetricsLogger(log_dir)
            if profile_steps:
                self.profile = ProfileWindow(tuple(profile_steps), log_dir, fdbm.device)

    def fit(self, resume: bool = True, resume_from: Optional[str] = None,
            init_weights: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """Train; ``resume_from`` starts from another run's ``last`` slot,
        otherwise ``resume`` continues this run's own; ``init_weights`` (a
        backbone ``state_dict``, e.g. a pretrained model's EMA weights)
        become both the parameters and the EMA weights of a fresh start.
        Returns the state.

        Runs with cuDNN's benchmark mode on (restored after): training
        repeats a few fixed shapes, so timing each convolution's algorithms
        once pays, where cuDNN's heuristic picks an FFT-tiled weight
        gradient for NCSN++ that dominates its step (PERF.md §6)."""
        saved = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            return self._fit(resume, resume_from, init_weights)
        finally:
            torch.backends.cudnn.benchmark = saved
            if self.profile is not None:
                self.profile.stop()

    def _fit(self, resume: bool, resume_from: Optional[str],
             init_weights: Optional[Dict[str, torch.Tensor]]) -> TrainState:
        fdbm = self.fdbm
        if init_weights is not None:
            fdbm.dnn.load_state_dict(init_weights)
        state = TrainState(fdbm.dnn)
        say = print if self.rank == 0 else (lambda *a: None)
        if resume_from:
            src = CheckpointManager(resume_from)
            if not src.has("last"):
                raise FileNotFoundError(f"No 'last' checkpoint in {resume_from}")
            src.restore("last", fdbm, state)
            say(f"resumed from {resume_from} at step {state.step}")
        elif resume and os.path.exists(os.path.join(self.ckpt_dir, "last.pt")):
            CheckpointManager(self.ckpt_dir).restore("last", fdbm, state)
            say(f"resumed from step {state.step}")
        # Every process starts from process 0's weights and optimiser state.
        broadcast_train_state(fdbm, state)

        # Each process loads its [rank::world] share of the files and
        # batch_size / world rows of each global batch; the batch counts
        # come from the global file counts, so every process takes as many
        # collective steps.
        world = self.world
        if self.data_cfg.batch_size % world:
            raise ValueError(f"batch_size {self.data_cfg.batch_size} must divide by the "
                             f"{world} processes")
        bs = self.data_cfg.batch_size // world
        train_set = SpecsDataset(self.data_cfg, "train", shuffle_spec=True, seed=self.seed,
                                 shard_by_process=world > 1)
        valid_set = SpecsDataset(self.data_cfg, "valid", shuffle_spec=False, seed=self.seed,
                                 shard_by_process=world > 1)
        workers = self.data_cfg.num_workers
        train_loader = BatchLoader(train_set, bs, shuffle=True, num_workers=workers,
                                   drop_last=True, seed=self.seed,
                                   num_batches=train_set.effective_global_len // world // bs)
        # Wrap-padded remainder with a mask, so every valid item counts once.
        valid_per_process = -(-valid_set.effective_global_len // world)
        valid_loader = BatchLoader(valid_set, bs, shuffle=False, num_workers=workers,
                                   drop_last=False, seed=self.seed, yield_mask=True,
                                   num_batches=-(-valid_per_process // bs))
        generator = torch.Generator(device=fdbm.device).manual_seed(self.seed)

        epoch = 0
        t_last = time.perf_counter()
        while state.step < self.max_steps and epoch < self.max_epochs:
            train_set.sample_data_per_epoch()
            for batch in train_loader:
                if self.profile is not None:
                    self.profile.before_step(state.step)
                with record_function("train_step"):  # a span of the profiler's trace
                    metrics = data_parallel_train_step(fdbm, state, fdbm.to_device(batch),
                                                       generator)
                if self.profile is not None:
                    self.profile.after_step(state.step)
                if state.step % self.log_every == 0 and self.logger is not None:
                    now = time.perf_counter()
                    metrics["steps_per_sec"] = self.log_every / (now - t_last)
                    t_last = now
                    self.logger.log(state.step, metrics)
                if state.step >= self.max_steps:
                    break
            val_losses, val_counts = [], []
            for batch in valid_loader:
                loss = data_parallel_valid_step(fdbm, state, fdbm.to_device(batch), generator)
                if batch[2].sum() > 0:  # a process's all-padding batch has no loss
                    val_losses.append(loss)
                    val_counts.append(float(batch[2].sum()))
            val_metrics: Dict[str, float] = {}
            counts: Dict[str, int] = {}
            if val_losses:
                val_metrics["valid_loss"] = float(np.average(val_losses, weights=val_counts))
                counts["valid_loss"] = int(sum(val_counts))
            if self.num_eval_files > 0:
                # The evaluation samples on a generator of its own, seeded by
                # one draw of the training generator: every process's
                # training draws stay in step, whatever its share of files.
                seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                         device=generator.device))
                eval_gen = torch.Generator(device=fdbm.device).manual_seed(seed + self.rank)
                if self.rank == 0:
                    os.makedirs(self.sample_dir, exist_ok=True)
                means, n = evaluate_files(fdbm, state.ema, valid_set, self.num_eval_files,
                                          eval_gen, sample_dir=self.sample_dir, epoch=epoch)
                val_metrics.update(means)
                counts.update(n)
            # Every process enters the gather, also with an empty shard.
            val_metrics = all_gather_host_metrics(val_metrics, counts, VALID_METRIC_SCHEMA)
            if self.rank == 0:
                if val_metrics:
                    self.logger.log(state.step, val_metrics)
                self.ckpt.save(fdbm, state, val_metrics)
            distributed.barrier()
            epoch += 1
        if self.rank == 0:
            self.ckpt.save(fdbm, state)
            self.logger.close()
        loaded = train_set.loaded
        say(f"[data] train items: native {loaded['native']}, read_wav {loaded['read_wav']}, "
            f"load seconds {loaded['seconds']:.3f}")
        distributed.barrier()
        return state


def build_from_config(cfg: Dict[str, Any], device="cuda"):
    fdbm = FDBM(FDBMConfig.from_dict(cfg), device=device)
    data_fields = {f.name for f in dataclasses.fields(DataConfig)}
    return fdbm, DataConfig(**{k: v for k, v in cfg.items() if k in data_fields})


def launch(worker: Callable[..., Any], devices: Optional[int], device: str, *args: Any):
    """Run ``worker(*args)`` as ``-D`` and torchrun ask:
    ``-D N > 1`` spawns N processes (``distributed.spawn``; more than the
    visible cards raises), under torchrun this process joins its group,
    otherwise it runs alone. The first of ``args`` is the run directory,
    which under torchrun is process 0's. A group this call joined is left
    after ``worker``. Returns what ``worker`` returns (nothing after a
    spawn)."""
    if devices is not None and devices > 1:
        if distributed.under_launcher():
            raise ValueError(f"-D {devices} starts its own processes; under torchrun give "
                             "--nproc_per_node instead")
        if torch.device(device).type == "cuda":
            make_mesh(devices)
        distributed.spawn(worker, devices, device, *args)
        return None
    with distributed.launched(device):
        return worker(distributed.broadcast_object(args[0]), *args[1:])


def _train(log_dir: str, args: argparse.Namespace, cfg: Dict[str, Any]) -> str:
    torch.manual_seed(args.seed)
    fdbm, data_cfg = build_from_config(cfg, distributed.process_device(args.device))
    trainer = Trainer(fdbm, data_cfg, log_dir, max_steps=args.max_steps,
                      max_epochs=args.max_epochs,
                      num_eval_files=int(cfg.get("num_eval_files", 20)),
                      save_ckpt_interval=int(cfg.get("save_ckpt_interval", 20000)),
                      seed=args.seed, config_blob=cfg, snapshot=not args.nolog,
                      profile_steps=args.profile_steps)
    ckpt = args.ckpt or cfg.get("ckpt")
    if ckpt and os.path.isdir(os.path.join(ckpt, "checkpoints")):
        ckpt = os.path.join(ckpt, "checkpoints")
    state = trainer.fit(resume=bool(args.resume), resume_from=ckpt)
    if process_index() == 0:
        print(f"trained to step {state.step} in {log_dir}")
    return log_dir


def build_parser() -> argparse.ArgumentParser:
    """The CLI's arguments."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-C", "--config", required=True)
    ap.add_argument("-D", "--devices", type=int, default=None,
                    help="data-parallel processes on this machine, one a card (default 1)")
    ap.add_argument("--device", default="cuda", help="torch device to train on")
    ap.add_argument("--ckpt", default=None,
                    help="start from another run's (or checkpoints dir's) 'last' slot")
    ap.add_argument("--resume", default=None, metavar="RUN_DIR",
                    help="continue this run directory from its 'last' slot")
    ap.add_argument("--profile_steps", type=int, nargs=2, default=None,
                    metavar=("START", "END"),
                    help="torch.profiler trace of train steps START..END into <run>/profile")
    ap.add_argument("--max_steps", type=int, default=1_000_000)
    ap.add_argument("--max_epochs", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nolog", action="store_true", help="no code snapshot in <run>/code")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the CLI; returns the run directory."""
    args = build_parser().parse_intermixed_args(argv)

    cfg = load_config(args.config, parse_cli_overrides(args.overrides))
    if args.resume:
        log_dir = args.resume
        if not os.path.isdir(os.path.join(log_dir, "checkpoints")):
            raise SystemExit(f"--resume {log_dir}: no checkpoints/ dir found "
                             "(expected an existing run directory)")
    else:
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        log_dir = os.path.join(cfg.get("log_dir", "./logs"), f"{cfg.get('version', 'run')}_{stamp}")
    launch(_train, args.devices, args.device, log_dir, args, cfg)
    return log_dir


if __name__ == "__main__":
    main()
