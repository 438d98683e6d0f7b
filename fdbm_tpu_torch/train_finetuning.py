"""Fine-tuning CLI of the port: the "enhanced bridge".

    python -m fdbm_tpu_torch.train_finetuning -C configs/config_finetuning.yaml \
        ckpt=<run, checkpoints dir, slot or reference .ckpt> [key=value ...] \
        [--device cpu] [-D N] [--slot last] [--max_steps N] [--max_epochs N] [--seed S]

Port of the root ``train_finetuning.py``: a pretrained bridge is trained
through its own unrolled ODE-EI sampler (``mode="finetuning"``, a gradient
through the last backbone call only, ``FDBM._finetune_unrolled``). The
architecture, STFT and bridge come from the pretrained checkpoint's config;
the fine-tuning YAML and the command line set only the training fields in
``OVERRIDABLE``. The pretrained weights are the source's EMA weights (slot
``--slot`` of a port run, ``last`` where it was never written, or a
reference Lightning ``.ckpt``); they start both the parameters and the EMA
weights. An orbax checkpoint of the JAX package reaches the port through
``tools/export_torch_ckpt.py``. Runs on the GPU unless ``--device cpu`` is
given; ``-D N`` and torchrun train data-parallel, as ``fdbm_tpu_torch.train``
does (``train.launch``).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
from typing import Any, Dict, Optional, Sequence

from fdbm_tpu_torch.checkpoint import read_checkpoint
from fdbm_tpu_torch.config import load_config, parse_cli_overrides
from fdbm_tpu_torch.data import DataConfig
from fdbm_tpu_torch.model import FDBM, FDBMConfig
from fdbm_tpu_torch.parallel.distributed import process_device, process_index
from fdbm_tpu_torch.train import Trainer, launch

# The training-procedure fields the fine-tuning config may set; every other
# field comes from the pretrained checkpoint. The JAX package's set, and
# compute_dtype: fine-tuning keeps its source's unless the config names one.
OVERRIDABLE = frozenset({
    "N", "batch_size", "lr", "scheduler_config", "loss_type", "l1_weight", "pesq_weight",
    "num_eval_files", "save_ckpt_interval", "base_dir", "log_dir", "version", "num_workers",
    "num_data_per_epoch", "dummy", "accumulate_grad_batches", "compute_dtype",
})


def _finetune(log_dir: str, args: argparse.Namespace, cfg: Dict[str, Any]) -> str:
    pretrain_cfg, weights = read_checkpoint(cfg["ckpt"], args.slot)
    merged = {**pretrain_cfg,
              **{k: v for k, v in cfg.items() if k in OVERRIDABLE and v is not None}}
    merged["mode"] = "finetuning"
    merged["sampler_type"] = "ode_ei"
    fdbm = FDBM(FDBMConfig.from_dict(merged), device=process_device(args.device))
    data_fields = {f.name for f in dataclasses.fields(DataConfig)}
    data_cfg = DataConfig(**{k: v for k, v in merged.items() if k in data_fields})
    trainer = Trainer(fdbm, data_cfg, log_dir, max_steps=args.max_steps,
                      max_epochs=args.max_epochs,
                      num_eval_files=int(merged.get("num_eval_files", 20)),
                      save_ckpt_interval=int(merged.get("save_ckpt_interval", 20000)),
                      seed=args.seed, config_blob=merged)
    state = trainer.fit(resume=False, init_weights=weights)
    if process_index() == 0:
        print(f"fine-tuned to step {state.step} in {log_dir}")
    return log_dir


def build_parser() -> argparse.ArgumentParser:
    """The CLI's arguments."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-C", "--config", required=True)
    ap.add_argument("-D", "--devices", type=int, default=None,
                    help="data-parallel processes on this machine, one a card (default 1)")
    ap.add_argument("--device", default="cuda", help="torch device to train on")
    ap.add_argument("--slot", default="last", help="checkpoint slot of the pretrained run")
    ap.add_argument("--max_steps", type=int, default=1_000_000)
    ap.add_argument("--max_epochs", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the CLI; returns the run directory."""
    args = build_parser().parse_intermixed_args(argv)

    cfg = load_config(args.config, parse_cli_overrides(args.overrides))
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    log_dir = os.path.join(cfg.get("log_dir", "./logs"),
                           f"{cfg.get('version', 'finetune')}_{stamp}")
    launch(_finetune, args.devices, args.device, log_dir, args, cfg)
    return log_dir


if __name__ == "__main__":
    main()
