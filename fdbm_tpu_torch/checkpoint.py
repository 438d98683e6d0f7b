"""The port's checkpoint: one file holding the config and the weights.

Written by ``torch.save({"config": dict, "state_dict": ...})`` and read back
with ``weights_only=True``. The JAX package's orbax checkpoints need JAX to
read; they reach the port through an export to this format on the JAX side.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from fdbm_tpu_torch.model import FDBM, FDBMConfig


def save_checkpoint(path: str, fdbm: FDBM) -> None:
    """Write ``fdbm``'s config and backbone weights to one file."""
    state = {k: v.detach().cpu() for k, v in fdbm.dnn.state_dict().items()}
    torch.save({"config": dataclasses.asdict(fdbm.cfg), "state_dict": state}, path)


def load_checkpoint(path: str, device="cuda",
                    overrides: Optional[Dict[str, Any]] = None) -> FDBM:
    """Rebuild the model from a checkpoint file on ``device``. Non-None
    ``overrides`` (e.g. an inference config's N or sampler_type) replace the
    stored config fields of the same name; other keys are ignored."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    cfg = dict(blob["config"])
    if overrides:
        cfg.update({k: v for k, v in overrides.items() if v is not None})
    fdbm = FDBM(FDBMConfig.from_dict(cfg), device=device)
    fdbm.dnn.load_state_dict(blob["state_dict"])
    return fdbm
