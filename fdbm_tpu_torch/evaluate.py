"""Metric evaluation CLI of the port: enhanced wavs against clean references.

    python -m fdbm_tpu_torch.evaluate --clean_dir <clean> --enhanced_dir <enhanced> \
        [--noisy_dir <noisy>] [--sr 16000] [--device cpu]

Port of the root ``evaluate.py``: for every wav under ``--enhanced_dir``
the clean file of the same relative path (else of the same name), both cut
to the shorter, scored by SI-SDR, ESTOI and wideband PESQ (the ITU ``pesq``
package when importable, else the port's estimator on ``--device``, the
GPU by default), and with ``--noisy_dir`` the SI-SIR and SI-SAR energy
ratios. Prints the same JSON summary: per metric the mean, spread, 95 %
confidence half-width and count, then the file and missing-reference
counts. TF32 is off, so the estimator runs in full fp32 on the card.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from fdbm_tpu_torch.utils import metrics as M
from fdbm_tpu_torch.utils.audio import read_wav, resample


def _load(path: str, sr: int = 16000) -> np.ndarray:
    x, file_sr = read_wav(path)
    x = x[0]
    return resample(x, file_sr, sr) if file_sr != sr else x


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI; returns the summary it prints."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clean_dir", required=True)
    ap.add_argument("--enhanced_dir", required=True)
    ap.add_argument("--noisy_dir", default=None)
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--device", default="cuda", help="torch device of the PESQ estimator")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    enhanced = sorted(glob(os.path.join(args.enhanced_dir, "**", "*.wav"), recursive=True))
    results: Dict[str, list] = {"si_sdr": [], "estoi": [], "pesq": [], "si_sir": [],
                                "si_sar": []}
    missing = 0
    for ep in enhanced:
        rel = os.path.relpath(ep, args.enhanced_dir)
        cp = os.path.join(args.clean_dir, rel)
        if not os.path.exists(cp):
            cp = os.path.join(args.clean_dir, os.path.basename(ep))
        if not os.path.exists(cp):
            missing += 1
            continue
        x = _load(cp, args.sr)
        x_hat = _load(ep, args.sr)
        n = min(len(x), len(x_hat))
        x, x_hat = x[:n], x_hat[:n]
        results["si_sdr"].append(M.si_sdr(x, x_hat))
        e = M.estoi(x, x_hat, args.sr)
        if np.isfinite(e):
            results["estoi"].append(e)
        p = M.pesq_wb(args.sr, x, x_hat, args.device)
        if p is not None:
            results["pesq"].append(p)
        if args.noisy_dir:
            np_path = os.path.join(args.noisy_dir, rel)
            if os.path.exists(np_path):
                y = _load(np_path, args.sr)[:n]
                _, sir, sar = M.energy_ratios(x_hat, x, y - x)
                results["si_sir"].append(sir)
                results["si_sar"].append(sar)

    summary: Dict[str, Any] = {}
    for k, v in results.items():
        if v:
            mean, std = M.mean_std(np.asarray(v))
            ci = M.mean_conf_int(v)[1] if len(v) > 1 else 0.0
            summary[k] = {"mean": round(mean, 4), "std": round(std, 4), "ci95": round(ci, 4),
                          "n": len(v)}
    summary["files"] = len(enhanced)
    summary["missing_refs"] = missing
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
