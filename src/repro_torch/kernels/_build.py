"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own by
nvcc for Hopper (`sm_90a`) into `build/torch_kernels/<name>-<hash>.so` at the
root of the checkout, then loaded with ctypes. The hash covers the source,
the shared header and the flags, so a library is rebuilt only when one of
them changes. `build_all` starts one nvcc per source, all at once.

Every C entry point launches on the card and stream it is given (the card
that holds its tensors and PyTorch's current stream there, `launch_on`) and
returns `cudaGetLastError()`; `check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("block_histograms", "partition_ranks", "hash_probe", "clustered_gather", "probe_agg",
           "segsum_partials", "lower_bound", "histogram")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# argtypes of each C entry point, by library; each ends with the stream and
# the card (`launch_on`)
SIGNATURES = {
    "block_histograms": {"block_histograms": (_P, _L, _I, _I, _P, _P, _I)},
    "partition_ranks": {"partition_ranks": (_P, _P, _L, _I, _I, _P, _P, _I)},
    "hash_probe": {"hash_probe": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _P, _P, _P, _I)},
    "clustered_gather": {"clustered_gather": (_P, _P, _L, _L, _I, _P, _P, _I)},
    "probe_agg": {"probe_agg": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                                _P, _P, _P, _P, _I)},
    "segsum_partials": {"segsum_partials": (_P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _I),
                        "segsum_partials_state_words": (_L, _I)},
    "lower_bound": {"lower_bound": (_P, _I, _P, _L, _I, _P, _P, _I)},
    "histogram": {"histogram": (_P, _L, _I, _P, _P, _I)},
}

# entry points that return something other than an error code
RESTYPES = {"segsum_partials_state_words": ctypes.c_longlong}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file


def build_all(names=SOURCES) -> None:
    """Compile every missing library, one nvcc per source in parallel."""
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
        lib.kernel_error_string.argtypes = (ctypes.c_int,)
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch_on(t) -> tuple[int, int]:
    """(stream, card) for a C entry point: the handle of PyTorch's current
    stream on t's card, and that card's ordinal, which the entry point makes
    current for its launch. The handle is read without building a
    `torch.cuda.Stream` (a few microseconds a launch, which short kernels
    feel)."""
    import torch

    device = t.get_device()
    return torch._C._cuda_getCurrentRawStream(device), device


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err} ({msg})")
