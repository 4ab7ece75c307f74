"""repro_torch — the PyTorch and CUDA port of the `repro` package, for one
NVIDIA Hopper card. It imports torch and numpy only; the JAX package stays
the reference it is tested against.

Ported so far: the joins (the partitioned hash join, pk_fk and m:n; the
sort-merge join; the non-partitioned hash join; GFTR and GFUR
materialization; join sequences), the fused group-join, the five group-by
strategies, the checked drivers on the escalation ladder, the join planner
and the GFUR/GFTR memory model (`core`), with the hand-written CUDA
kernels (`kernels`, each declared by its record beside its wrapper,
`kernels.common.register`: they stand for the reference's Pallas kernels
and move the partition planner's passes); the cost-based query engine:
logical plans, statistics, the optimizer and its physical plans, the
executor and the memory budget (`engine`); the
escalation runtime and fault injection (`resilience`), the metrics
registry, residuals and the calibration store (`obs`), the relational
workload generator and the feature-join pipeline that feeds LM training
with PHJ-joined, tokenized features (`data`); and the LM stack: the
architecture configs (`configs`), the models of every family — dense, MoE
(whose token routing runs on the radix-partition kernels), xLSTM, the
zamba2 hybrid, vision and audio (`models`) — the sharding rule tables
(`dist`), the continuous-batching decode server (`serve.engine`), the
trainer (`train`) and the two launchers (`launch`).
"""
