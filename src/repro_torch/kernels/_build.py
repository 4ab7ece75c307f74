"""Build and load the hand-written CUDA kernels.

Each registered kernel's `csrc/<name>.cu` (`common.Kernel`) has a plain C
interface and is compiled on its own by nvcc for Hopper (`sm_90a`) into
`build/torch_kernels/<name>-<hash>.so` at the root of the checkout, then
loaded with ctypes, its entry points typed from the record (`bind`). The hash covers the source,
the shared header and the flags, so a library is rebuilt only when one of
them changes. `build_all` starts one nvcc per source, all at once.

Every C entry point launches on the card and stream it is given (the card
that holds its tensors and PyTorch's current stream there, `launch_on`) and
returns `cudaGetLastError()`; `checked` raises when that is not 0, and
`launch` counts the launch where it is 0. A kernel that cannot be built (no
toolkit, nvcc fails) or launched raises `KernelError`, which the engine
never answers by re-planning around it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

from .common import KERNELS, LAUNCHES

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# the C types of the entry points' arguments (`Kernel.entries`)
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel could not be built or launched: a fault of the
    port, never a condition to degrade around."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
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
        raise KernelError(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file


def build_all(names=KERNELS) -> None:
    """Compile every missing library, one nvcc per source in parallel."""
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        _finish(n, job)


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set the argument and result types of `name`'s entry points in `lib`
    (also a library built from another commit's source), from its record;
    an entry point the library lacks is left out. `<name>_launch_config`'s
    arguments carry their own types (`Kernel.config`)."""
    k = KERNELS[name]
    sigs = {fn: (args, k.restypes.get(fn, ctypes.c_int)) for fn, args in k.entries.items()}
    # instance, card, room for six int64s (`kernel_lint.ATTRIBUTES`)
    sigs[f"{name}_func_attributes"] = ((I32, I32, PTR), ctypes.c_int)
    sigs[f"{name}_instance_name"] = ((I32,), ctypes.c_char_p)
    sigs["kernel_error_string"] = ((I32,), ctypes.c_char_p)
    for fn, (argtypes, restype) in sigs.items():
        f = getattr(lib, fn, None)
        if f is not None:
            f.argtypes, f.restype = argtypes, restype
    return lib


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = _libs[name] = bind(ctypes.CDLL(str(_lib_path(name))), name)
    return lib


def call(kernel: str, entry: str, *args):
    """What one of `kernel`'s C entry points returns, its library built and
    loaded first."""
    return getattr(load(kernel), entry)(*args)


def checked(kernel: str, entry: str, *args) -> None:
    """Call an entry point that returns a CUDA error code; KernelError naming
    the kernel where it is not 0."""
    err = call(kernel, entry, *args)
    if err != 0:
        msg = load(kernel).kernel_error_string(err).decode()
        raise KernelError(f"CUDA kernel {kernel}: {entry} failed: error {err} ({msg})")


def launch(kernel: str, entry: str, *args, on) -> None:
    """Launch `kernel` by its C entry point `entry` with `args`, on the card
    that holds the tensor `on` and PyTorch's current stream there; one
    launch counted in `LAUNCHES` once the entry point returns no error."""
    checked(kernel, entry, *args, *launch_on(on))
    LAUNCHES[kernel] += 1


def launch_on(t) -> tuple[int, int]:
    """(stream, card) for a C entry point: the handle of PyTorch's current
    stream on t's card, and that card's ordinal, which the entry point makes
    current for its launch. The handle is read without building a
    `torch.cuda.Stream` (a few microseconds a launch, which short kernels
    feel)."""
    import torch

    device = t.get_device()
    return torch._C._cuda_getCurrentRawStream(device), device
