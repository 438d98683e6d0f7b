"""The port's checkpoints: single model files and the trainer's slots.

* :func:`save_checkpoint` writes one ``.pt`` with the config and the
  backbone's weights.
* :class:`CheckpointManager` keeps the JAX package's five training slots
  (``fdbm_tpu/checkpoint.py``): ``last``, ``step_<n>``, ``best_valid_loss``,
  ``best_pesq`` and ``best_si_sdr``, each one ``<slot>.pt`` holding the
  config, the parameters, the train state (EMA weights, Adam state, step
  and update counts), beside a ``meta.json`` with the best metrics and the
  config.
* :func:`load_checkpoint` rebuilds a model for serving from either: a
  model file, a slot file, or a run or checkpoints directory (slot
  ``last`` by default). From a slot it serves the EMA weights, as the JAX
  package's ``infer_single.py`` does.

Files are read back with ``weights_only=True``. The JAX package's orbax
checkpoints need JAX to read and do not load here.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional

import torch

from fdbm_tpu_torch.model import FDBM, FDBMConfig, TrainState


def _cpu(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in state.items()}


def save_checkpoint(path: str, fdbm: FDBM) -> None:
    """Write ``fdbm``'s config and backbone weights to one file."""
    torch.save({"config": dataclasses.asdict(fdbm.cfg), "state_dict": _cpu(fdbm.dnn.state_dict())},
               path)


class CheckpointManager:
    """Five-slot checkpoint manager with best-metric tracking."""

    def __init__(self, ckpt_dir: str, save_interval: int = 20000,
                 config: Optional[Dict[str, Any]] = None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.save_interval = save_interval
        self.config = config or {}
        self.best = {"valid_loss": math.inf, "pesq": -math.inf, "si_sdr": -math.inf}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.best.update({k: float(v) for k, v in json.load(f).get("best", {}).items()})

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.ckpt_dir, "meta.json")

    def path(self, slot: str) -> str:
        return os.path.join(self.ckpt_dir, f"{slot}.pt")

    def has(self, slot: str) -> bool:
        return os.path.exists(self.path(slot))

    def _write(self, slot: str, fdbm: FDBM, state: TrainState) -> None:
        blob = {"config": dataclasses.asdict(fdbm.cfg), "state_dict": _cpu(fdbm.dnn.state_dict()),
                "train_state": state.state_dict()}
        tmp = self.path(slot) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self.path(slot))
        with open(self._meta_path, "w") as f:
            json.dump({"best": self.best, "config": self.config}, f, indent=2)

    def save(self, fdbm: FDBM, state: TrainState,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Save ``last``, the periodic step slot, and any best-metric slots."""
        self._write("last", fdbm, state)
        if self.save_interval and state.step % self.save_interval == 0 and state.step > 0:
            self._write(f"step_{state.step}", fdbm, state)
        metrics = metrics or {}
        for name, better in (("valid_loss", lambda a, b: a < b), ("pesq", lambda a, b: a > b),
                             ("si_sdr", lambda a, b: a > b)):
            if name in metrics and better(metrics[name], self.best[name]):
                self.best[name] = metrics[name]
                self._write(f"best_{name}", fdbm, state)

    def restore(self, slot: str, fdbm: FDBM, state: TrainState) -> None:
        """Load a slot's parameters into ``fdbm.dnn`` and its train state
        into ``state``."""
        blob = torch.load(self.path(slot), map_location="cpu", weights_only=True)
        fdbm.dnn.load_state_dict(blob["state_dict"])
        state.load_state_dict(blob["train_state"])


def _resolve_checkpoint(path: str, slot: str = "last") -> str:
    """The file :func:`load_checkpoint` reads for ``path``: the file itself,
    or ``<slot>.pt`` of a checkpoints directory or of a run directory's
    ``checkpoints/``."""
    if os.path.isfile(path):
        return path
    ckpt_dir = os.path.join(path, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        ckpt_dir = path
    found = os.path.join(ckpt_dir, f"{slot}.pt")
    if not os.path.isfile(found):
        raise FileNotFoundError(f"no checkpoint slot {slot!r} in {path}")
    return found


def load_checkpoint(path: str, device="cuda", overrides: Optional[Dict[str, Any]] = None,
                    slot: str = "last") -> FDBM:
    """Rebuild the model from a checkpoint on ``device`` for serving: a
    model file's weights, or a training slot's EMA weights. Non-None
    ``overrides`` (e.g. an inference config's N or sampler_type) replace
    the stored config fields of the same name; other keys are ignored."""
    blob = torch.load(_resolve_checkpoint(path, slot), map_location="cpu", weights_only=True)
    cfg = dict(blob["config"])
    if overrides:
        cfg.update({k: v for k, v in overrides.items() if v is not None})
    fdbm = FDBM(FDBMConfig.from_dict(cfg), device=device)
    train_state = blob.get("train_state")
    fdbm.dnn.load_state_dict(train_state["ema"] if train_state else blob["state_dict"])
    return fdbm
