"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions, for the paper's hot spots on the join and group-by path:

  histogram        global digit histogram
  radix_partition  per-tile digit histograms and stable partition ranks,
                   composed into the sort-free multi-pass partition and
                   sort planners
  merge_join       lower bounds of sorted probe keys (SMJ match finding)
  hash_probe       co-partition probe over the partitioned key columns (each
                   partition's build keys in a shared-memory hash table), and
                   the group-join's fused probe + tile-local aggregate
  gather           GFTR clustered gather of 4- and 8-byte elements
  segsum           per-tile partial sums over key-sorted rows (sort group-by)

Sources live in `repro_torch/csrc/`, are compiled by nvcc at first use
(`_build`), and are loaded with ctypes. A CUDA tensor runs the kernel, a CPU
tensor the plain version in `ref`.
"""
from . import histogram, ops, ref  # histogram: the module (its kernel is histogram.histogram)
from .gather import clustered_gather
from .hash_probe import layout_probe_blocks, probe_agg
from .merge_join import lower_bound
from .radix_partition import block_histograms, partition_plan, partition_ranks, sort_plan_radix
from .segsum import segsum_partials

__all__ = [
    "ops", "ref", "histogram",
    "block_histograms", "partition_ranks", "partition_plan", "sort_plan_radix",
    "lower_bound",
    "layout_probe_blocks", "probe_agg",
    "clustered_gather",
    "segsum_partials",
]
