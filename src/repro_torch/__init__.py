"""repro_torch — the PyTorch and CUDA port of the `repro` package, for one
NVIDIA Hopper card. It imports torch and numpy only; the JAX package stays
the reference it is tested against.

Ported so far: the partitioned hash join with GFTR materialization (PHJ-OM),
the fused group-join, and the sort, sort_pallas and partition group-bys
(`core`), with the sort-free radix partition planner, the co-partition
probe, the clustered gather, the fused probe + aggregate and the per-tile
segmented sums as hand-written CUDA kernels (`kernels`), and the relational
workload generator (`data`).
"""
