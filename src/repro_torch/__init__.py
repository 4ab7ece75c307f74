"""repro_torch — the PyTorch and CUDA port of the `repro` package, for one
NVIDIA Hopper card. It imports torch and numpy only; the JAX package stays
the reference it is tested against.

Ported so far: the joins (the partitioned hash join, pk_fk and m:n; the
sort-merge join; the non-partitioned hash join; GFTR and GFUR
materialization; join sequences), the fused group-join, the five group-by
strategies, the checked drivers on the escalation ladder, the join planner
and the GFUR/GFTR memory model (`core`), with the eight hand-written CUDA
kernels that stand for the reference's Pallas kernels (`kernels`); the
cost-based query engine: logical plans, statistics, the optimizer and its
physical plans, the executor and the memory budget (`engine`); the
escalation runtime and fault injection (`resilience`), the metrics
registry, residuals and the calibration store (`obs`), and the relational
workload generator (`data`); and the first slice of the LM stack: the
architecture configs (`configs`), the dense and MoE models whose token
routing runs on the radix-partition kernels (`models`), the sharding rule
tables (`dist`), the continuous-batching decode server (`serve.engine`) and
its launcher (`launch.serve`).
"""
