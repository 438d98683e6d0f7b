"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface; no source includes PyTorch's headers, so a build takes seconds.
The libraries go to ``fdbm_tpu_torch/_build/``, named by a hash of every
file under ``csrc/`` and of the nvcc flags, and are built at first use, all
sources at once in parallel. Nothing here runs at import time: the CPU
tests import the package on machines with no nvcc.

Every C entry returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception. A launch through
ctypes is invisible to autograd, so a wrapper without a backward kernel
calls :func:`refuse_grad` first: on such a wrapper a gradient would
silently stop.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Set, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_bound: Set[Tuple[str, str]] = set()  # (library, function) whose argtypes are set


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}_{_digest()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "first use and need the CUDA toolkit")


def build_all() -> Dict[str, object]:
    """Compile every source whose library is missing; one nvcc per source,
    all started together. Returns the wall seconds, the library paths and
    the compiler's resource report (``-Xptxas=-v``) of the sources built."""
    with _lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {n: src for n, src in _sources().items()
                if not library_path(n).exists()}
        nvcc = _nvcc() if todo else None
        procs = {}
        for name, src in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        reports, failed = {}, []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            reports[name] = out
            if proc.returncode == 0:
                os.replace(tmp, library_path(name))
            else:
                os.unlink(tmp)
                failed.append(f"{name}.cu:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        return {"seconds": time.perf_counter() - t0,
                "built": sorted(todo),
                "libraries": {n: str(library_path(n)) for n in _sources()},
                "ptxas": reports}


def load(name: str, signatures: Dict[str, Sequence[object]],
         restypes: Optional[Dict[str, object]] = None) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built if needed, with the
    ``argtypes`` of the functions in ``signatures`` set, and their
    ``restype`` c_int unless ``restypes`` names another (set at the first
    call that names the function, so a wrapper's later calls skip it).
    Several modules may bind functions of one library, each naming its
    own."""
    with _lock:
        lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    for fn, argtypes in signatures.items():
        if (name, fn) not in _bound:
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = (restypes or {}).get(fn, ctypes.c_int)
            _bound.add((name, fn))
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def refuse_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would need a gradient through a forward-only kernel."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and an input requires grad; "
            "run it under torch.no_grad(), or take the training route "
            "(ops.gridrnn_train.grid_fold_train_pair and the plain attention)")
