"""Build and load the Hopper kernels of ``csrc/`` (nvcc + ctypes).

Each ``csrc/*.cu`` file compiles, on first use, into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

No PyTorch header is included, so a build takes seconds.  All sources are
compiled at once, one ``nvcc`` process each, started together.  The
libraries go to ``<repo>/build/repro_torch_kernels/<hash>/``, where the hash
covers every source and header and the flags: an edited source builds
anew, an unchanged one loads the library already there.  Each entry point
returns ``cudaGetLastError()`` after its launches (or an error code of its
own for arguments it has no kernel for); :func:`check` raises on non-zero.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD = ROOT / "build" / "repro_torch_kernels"

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the Hopper kernels "
                       "are built from source at first use")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> pathlib.Path:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / h.hexdigest()[:16]


def build_all() -> dict[str, pathlib.Path]:
    """Compile every missing library in parallel; returns name -> path.

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside each library as ``<name>.log``.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {s.stem: out / f"lib{s.stem}.so" for s in sources()}
    todo = [s for s in sources() if not paths[s.stem].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = []
    for s in todo:
        tmp = out / f"lib{s.stem}.so.{os.getpid()}.tmp"
        log = open(out / f"{s.stem}.log", "w")  # noqa: SIM115 - closed below
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(s)]
        procs.append((s, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for s, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(s.name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[s.stem])   # atomic: no half-written library
    if failed:
        logs = "\n".join((out / f"{pathlib.Path(f).stem}.log").read_text()
                         for f in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all()[name]))
        return lib


def bind(name: str, fn: str, argtypes):
    """``library(name).fn`` with its argument types declared (pointers and
    the stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    f = _fns.get((name, fn))
    if f is None:
        f = getattr(library(name), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _fns[(name, fn)] = f
    return f


def stream() -> int:
    """PyTorch's current CUDA stream, as the pointer the kernels launch on."""
    import torch

    return torch.cuda.current_stream().cuda_stream


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch is
    only visible here: ``torch.cuda.synchronize()`` does not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error code {rc}")
