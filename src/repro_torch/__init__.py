"""repro_torch — the PyTorch and CUDA port of the `repro` package, for one
NVIDIA Hopper card. It imports torch and numpy only; the JAX package stays
the reference it is tested against.

Ported so far: the partitioned hash join with GFTR materialization (PHJ-OM)
and the partition group-by (`core`), with the sort-free radix partition
planner, the co-partition probe and the clustered gather as hand-written
CUDA kernels (`kernels`), and the relational workload generator (`data`).
"""
