"""Folder inference CLI of the port.

    python -m fdbm_tpu_torch.infer_folder -C configs/config_infer_folder.yaml \
        ckpt=<model.pt | run dir | file.ckpt> test_dir=... enhanced_dir=... \
        [--batch_size 8] [--chunk_seconds 4.096] [--mesh_devices N] [--slot last] \
        [--device cpu]

The JAX package's ``infer_folder.py``: every wav/flac under ``test_dir`` is
enhanced in batches of ``--batch_size`` rows, with pooled chunks of
``--chunk_seconds`` (0 serves whole utterances), into ``enhanced_dir`` (the
tree kept with ``keep_structure``), and one JSON line of the run's stats is
printed. ``ckpt`` is what ``infer_single`` takes. Runs on the GPU unless
``--device cpu`` is given. ``--mesh_devices N`` splits every batch over the
cards ``cuda:0..N-1``, one replica of the model each (more than are visible
raises). Under ``torchrun`` each process serves its ``[rank::world]`` share
of the files on its card ``cuda:LOCAL_RANK`` and prints its own stats line.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from fdbm_tpu_torch.checkpoint import load_checkpoint
from fdbm_tpu_torch.config import load_config, parse_cli_overrides
from fdbm_tpu_torch.infer import EnhanceStats, enhance_folder
from fdbm_tpu_torch.parallel import distributed
from fdbm_tpu_torch.parallel.mesh import make_mesh


def main(argv: Optional[Sequence[str]] = None) -> EnhanceStats:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-C", "--config", required=True)
    ap.add_argument("--device", default="cuda", help="torch device to serve on")
    ap.add_argument("--slot", default="last", help="checkpoint slot of a training run")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--mesh_devices", type=int, default=0,
                    help="split each batch over this many GPUs, cuda:0..N-1 (0: one device)")
    ap.add_argument("--chunk_seconds", type=float, default=4.096,
                    help="pooled chunk serving: utterances longer than about this are split "
                         "into equal cross-faded chunks batched together (default: the "
                         "4.096 s training crop); 0 serves whole utterances")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = ap.parse_intermixed_args(argv)

    cfg = load_config(args.config, parse_cli_overrides(args.overrides))
    devices = None
    if args.mesh_devices:
        if distributed.under_launcher():
            raise ValueError("--mesh_devices splits batches over this machine's cards; under "
                             "torchrun each process serves on its own card")
        devices = make_mesh(args.mesh_devices) if torch.device(args.device).type == "cuda" \
            else [torch.device(args.device)] * args.mesh_devices
    with distributed.launched(args.device):
        device = devices[0] if devices else distributed.process_device(args.device)
        fdbm = load_checkpoint(cfg["ckpt"], device=device, overrides=cfg, slot=args.slot)
        stats = enhance_folder(
            fdbm, test_dir=cfg["test_dir"], enhanced_dir=cfg["enhanced_dir"],
            sampler_type=cfg.get("sampler_type"), N=int(cfg.get("N", 30)),
            batch_size=args.batch_size, keep_structure=bool(cfg.get("keep_structure", True)),
            sampler_kwargs=cfg.get("sampler_kwargs") or {},
            chunk_seconds=args.chunk_seconds or None, devices=devices)
    print(json.dumps({
        "files": stats.files,
        "failures": stats.failures,
        "audio_seconds": round(stats.audio_seconds, 2),
        "wall_seconds": round(stats.wall_seconds, 2),
        "audio_sec_per_sec": round(stats.throughput, 3),
    }), flush=True)
    return stats


if __name__ == "__main__":
    main()
