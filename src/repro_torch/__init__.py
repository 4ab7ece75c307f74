"""repro_torch — the PyTorch and CUDA port of the `repro` package, for one
NVIDIA Hopper card. It imports torch and numpy only; the JAX package stays
the reference it is tested against.

Ported so far: the joins (the partitioned hash join, pk_fk and m:n; the
sort-merge join; the non-partitioned hash join; GFTR and GFUR
materialization; join sequences), the fused group-join, the five group-by
strategies and the checked drivers on the escalation ladder (`core`), with
the eight hand-written CUDA kernels that stand for the reference's Pallas
kernels (`kernels`), the escalation runtime and fault injection
(`resilience`), the metrics registry (`obs`), and the relational workload
generator (`data`).
"""
