"""The byte formulas of the benchmark: per kernel launch and per query.

Each formula counts every input byte read once and every output byte
written once, whatever the kernel reads again. A launch's bound is its
bytes over the card's HBM bandwidth; a kernel's roofline share is the sum
of its launches' bounds over the sum of their device times. At the J2
shapes of PERF.md's kernel table (60M digits in 256 bins; r1, 15M int64
rows, through a 60M-row gather map) the bounds are 0.090, 0.161 and
0.251 ms. What a roofline metric captures around which wrapper is the
metric file's own (`CAPTURE`), so a kernel's roofline is a new file.
"""
from __future__ import annotations

import contextlib

# one NVIDIA H100 SXM (80 GB HBM3): NVIDIA's data sheet, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
# digits per tile of the partition kernels (kernels/radix_partition.TILE)
TILE = 1024
INT32 = 4


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def block_histograms_bytes(n: int, num_bins: int, tile: int = TILE) -> int:
    """n int32 digits in; ceil(n / tile) x num_bins int32 counts out."""
    return n * INT32 + ceil_div(n, tile) * num_bins * INT32


def partition_ranks_bytes(n: int, num_bins: int, tile: int = TILE) -> int:
    """n int32 digits and the (tiles, num_bins) int32 base in; n int32
    destinations out."""
    return n * INT32 + ceil_div(n, tile) * num_bins * INT32 + n * INT32


def clustered_gather_bytes(n_src: int, n: int, itemsize: int) -> int:
    """n int32 indices in; at most min(n_src, n) source elements read; n
    elements out."""
    return n * INT32 + min(n_src, n) * itemsize + n * itemsize


def bound_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S


def compulsory_bytes(tables: dict, reads, answer_bytes: int) -> int:
    """A query's compulsory bytes: each column it reads, once, and its
    answer. `reads` lists (table, column) pairs."""
    return sum(tables[t][c].numel() * tables[t][c].element_size()
               for t, c in reads) + answer_bytes


@contextlib.contextmanager
def capture_launch_bytes(captures: dict):
    """Within the block, every launch through a wrapper that `captures`
    names appends its bytes to the yielded {kernel: [bytes, ...]} lists.

    `captures` maps a kernel's name in the program's launch counter
    (`repro_torch.kernels.common.LAUNCHES`) to (module, attribute,
    bytes_fn): the Python wrapper that launches it, and the launch's bytes
    from the wrapper's arguments. A per-layer metric file declares what it
    reads as its `CAPTURE`; two files that capture one kernel share its
    entry (one imports the other's), or the run fails. Each wrapper is
    replaced for the block's length only; a call that launches nothing (an
    empty input, a CPU tensor) adds nothing. A wrapper that is not there
    fails the run."""
    import importlib

    from repro_torch.kernels.common import LAUNCHES

    rec = {kernel: [] for kernel in captures}
    orig = []

    def counted(kernel, fn, nbytes):
        def wrapper(*args, **kwargs):
            before = LAUNCHES[kernel]
            out = fn(*args, **kwargs)
            if LAUNCHES[kernel] > before:
                rec[kernel].append(nbytes(*args, **kwargs))
            return out
        return wrapper

    try:
        for kernel, (module, attr, nbytes) in captures.items():
            if kernel not in LAUNCHES:
                raise KeyError(f"the program counts no launches of {kernel!r}")
            mod = importlib.import_module(module)
            fn = getattr(mod, attr)
            orig.append((mod, attr, fn))
            setattr(mod, attr, counted(kernel, fn, nbytes))
        yield rec
    finally:
        for mod, attr, fn in reversed(orig):
            setattr(mod, attr, fn)
