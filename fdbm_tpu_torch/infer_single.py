"""Single-file inference CLI of the port.

    python -m fdbm_tpu_torch.infer_single -C configs/config_infer_single.yaml \
        ckpt=<file.pt> noisy_file=... output_file=... N=30 sampler_type=sde_ei

Same keys as the JAX package's ``infer_single.py``; ``ckpt`` names a
model file written by ``fdbm_tpu_torch.checkpoint.save_checkpoint``, a
training run (its directory, its ``checkpoints/``, one slot file or a
slot's path without ``.pt``), of which it serves the EMA weights of slot
``--slot`` (``last``; ``last`` too where that slot was never written), or a
reference PyTorch-Lightning ``.ckpt`` file (its EMA weights when present).
Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from fdbm_tpu_torch.checkpoint import load_checkpoint
from fdbm_tpu_torch.config import load_config, parse_cli_overrides
from fdbm_tpu_torch.infer import enhance_single


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-C", "--config", required=True)
    ap.add_argument("--device", default="cuda", help="torch device to serve on")
    ap.add_argument("--slot", default="last", help="checkpoint slot of a training run")
    ap.add_argument("--exact_shape", action="store_true",
                    help="run at the utterance's own length instead of the "
                         "64-frame bucket")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = ap.parse_intermixed_args(argv)

    cfg = load_config(args.config, parse_cli_overrides(args.overrides))
    fdbm = load_checkpoint(cfg["ckpt"], device=args.device, overrides=cfg, slot=args.slot)
    x_hat = enhance_single(
        fdbm, noisy_file=cfg["noisy_file"], output_file=cfg["output_file"],
        sampler_type=cfg.get("sampler_type"), N=int(cfg.get("N", 30)),
        sampler_kwargs=cfg.get("sampler_kwargs") or {}, exact_shape=args.exact_shape)
    print(f"wrote {cfg['output_file']} ({len(x_hat)} samples)")
    return x_hat


if __name__ == "__main__":
    main()
