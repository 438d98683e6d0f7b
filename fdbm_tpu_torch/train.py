"""Training CLI and loop of the port.

    python -m fdbm_tpu_torch.train -C configs/config.yaml [key=value ...] \
        [--device cpu] [--max_steps N] [--max_epochs N] [--seed S] \
        [--resume RUN_DIR] [--ckpt RUN_OR_CHECKPOINT_DIR]

Port of ``fdbm_tpu/train.py`` and the root ``train.py`` for one device:
train steps over ``SpecsDataset`` crops, scalars every
``log_every_n_steps`` steps to ``<run>/metrics.jsonl``, then per epoch the
valid loss under the EMA weights (the mean of the batch losses weighted by
their real items) and the five checkpoint slots. ``--resume`` continues a
run directory from its ``last`` slot; ``--ckpt`` starts a new run from
another run's ``last`` slot. Runs on the GPU unless ``--device cpu`` is
given.

Not ported yet: the per-epoch evaluation of ``num_eval_files`` files
(folder serving and the PESQ/ESTOI metrics, ROADMAP queue 1 items 3 and
8), so a config with ``num_eval_files > 0`` is refused; training on several
GPUs (queue 1 item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from fdbm_tpu_torch.checkpoint import CheckpointManager
from fdbm_tpu_torch.config import load_config, parse_cli_overrides
from fdbm_tpu_torch.data import BatchLoader, DataConfig, SpecsDataset
from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState


class MetricsLogger:
    """Scalars as JSON lines in ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        self.jsonl.close()


class Trainer:
    def __init__(self, fdbm: FDBM, data_cfg: DataConfig, log_dir: str,
                 max_steps: int = 1_000_000, max_epochs: int = 10_000,
                 num_eval_files: int = 20, save_ckpt_interval: int = 20000,
                 log_every_n_steps: int = 10, seed: int = 0,
                 config_blob: Optional[Dict[str, Any]] = None):
        if num_eval_files > 0:
            raise NotImplementedError(
                f"num_eval_files={num_eval_files}: the per-epoch evaluation needs folder "
                "serving and the PESQ/ESTOI metrics, which are not ported to fdbm_tpu_torch "
                "yet; pass num_eval_files=0")
        self.fdbm = fdbm
        self.data_cfg = data_cfg
        self.log_dir = log_dir
        self.max_steps = max_steps
        self.max_epochs = max_epochs
        self.log_every = log_every_n_steps
        self.seed = seed
        os.makedirs(log_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"),
                                      save_interval=save_ckpt_interval, config=config_blob)
        self.logger = MetricsLogger(log_dir)

    def fit(self, resume: bool = True, resume_from: Optional[str] = None) -> TrainState:
        """Train; ``resume_from`` starts from another run's ``last`` slot,
        otherwise ``resume`` continues this run's own. Returns the state."""
        fdbm = self.fdbm
        state = TrainState(fdbm.dnn)
        if resume_from:
            src = CheckpointManager(resume_from)
            if not src.has("last"):
                raise FileNotFoundError(f"No 'last' checkpoint in {resume_from}")
            src.restore("last", fdbm, state)
            print(f"resumed from {resume_from} at step {state.step}")
        elif resume and self.ckpt.has("last"):
            self.ckpt.restore("last", fdbm, state)
            print(f"resumed from step {state.step}")

        bs = self.data_cfg.batch_size
        train_set = SpecsDataset(self.data_cfg, "train", shuffle_spec=True, seed=self.seed)
        valid_set = SpecsDataset(self.data_cfg, "valid", shuffle_spec=False, seed=self.seed)
        workers = self.data_cfg.num_workers
        train_loader = BatchLoader(train_set, bs, shuffle=True, num_workers=workers,
                                   drop_last=True, seed=self.seed, num_batches=len(train_set) // bs)
        # Wrap-padded remainder with a mask, so every valid item counts once.
        valid_loader = BatchLoader(valid_set, bs, shuffle=False, num_workers=workers,
                                   drop_last=False, seed=self.seed, yield_mask=True,
                                   num_batches=-(-len(valid_set) // bs))
        generator = torch.Generator(device=fdbm.device).manual_seed(self.seed)

        epoch = 0
        t_last = time.perf_counter()
        while state.step < self.max_steps and epoch < self.max_epochs:
            train_set.sample_data_per_epoch()
            for batch in train_loader:
                metrics = fdbm.train_step(state, fdbm.to_device(batch), generator)
                if state.step % self.log_every == 0:
                    now = time.perf_counter()
                    metrics["steps_per_sec"] = self.log_every / (now - t_last)
                    t_last = now
                    self.logger.log(state.step, metrics)
                if state.step >= self.max_steps:
                    break
            val_losses, val_counts = [], []
            for batch in valid_loader:
                val_losses.append(fdbm.valid_step(state, fdbm.to_device(batch), generator))
                val_counts.append(float(batch[2].sum()))
            val_metrics: Dict[str, float] = {}
            if val_losses and sum(val_counts) > 0:
                val_metrics["valid_loss"] = float(np.average(val_losses, weights=val_counts))
                self.logger.log(state.step, val_metrics)
            self.ckpt.save(fdbm, state, val_metrics)
            epoch += 1
        self.ckpt.save(fdbm, state)
        self.logger.close()
        return state


def build_from_config(cfg: Dict[str, Any], device="cuda"):
    fdbm = FDBM(FDBMConfig.from_dict(cfg), device=device)
    data_fields = {f.name for f in dataclasses.fields(DataConfig)}
    return fdbm, DataConfig(**{k: v for k, v in cfg.items() if k in data_fields})


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the CLI; returns the run directory."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-C", "--config", required=True)
    ap.add_argument("--device", default="cuda", help="torch device to train on")
    ap.add_argument("--ckpt", default=None,
                    help="start from another run's (or checkpoints dir's) 'last' slot")
    ap.add_argument("--resume", default=None, metavar="RUN_DIR",
                    help="continue this run directory from its 'last' slot")
    ap.add_argument("--max_steps", type=int, default=1_000_000)
    ap.add_argument("--max_epochs", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = ap.parse_intermixed_args(argv)

    cfg = load_config(args.config, parse_cli_overrides(args.overrides))
    if args.resume:
        log_dir = args.resume
        if not os.path.isdir(os.path.join(log_dir, "checkpoints")):
            raise SystemExit(f"--resume {log_dir}: no checkpoints/ dir found "
                             "(expected an existing run directory)")
    else:
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        log_dir = os.path.join(cfg.get("log_dir", "./logs"), f"{cfg.get('version', 'run')}_{stamp}")

    fdbm, data_cfg = build_from_config(cfg, args.device)
    trainer = Trainer(fdbm, data_cfg, log_dir, max_steps=args.max_steps,
                      max_epochs=args.max_epochs,
                      num_eval_files=int(cfg.get("num_eval_files", 20)),
                      save_ckpt_interval=int(cfg.get("save_ckpt_interval", 20000)),
                      seed=args.seed, config_blob=cfg)
    ckpt = args.ckpt or cfg.get("ckpt")
    if ckpt and os.path.isdir(os.path.join(ckpt, "checkpoints")):
        ckpt = os.path.join(ckpt, "checkpoints")
    state = trainer.fit(resume=bool(args.resume), resume_from=ckpt)
    print(f"trained to step {state.step} in {log_dir}")
    return log_dir


if __name__ == "__main__":
    main()
