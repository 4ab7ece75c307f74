"""repro_torch.serve — relational query serving: the plan cache with
capacity bucketing, cost-priced admission, the bytes ticket and
per-signature circuit breakers (`query`), and its soak harness (`chaos`),
DESIGN.md §14. The JAX package's decode server (`serve/engine.py`) belongs
to the LM stack and is not ported yet."""
from .query import (CircuitBreaker, PlanEntry, QueryRequest, QueryServer, bucket_rows,
                    pad_table, plan_signature)

__all__ = ["CircuitBreaker", "PlanEntry", "QueryRequest", "QueryServer", "bucket_rows",
           "pad_table", "plan_signature"]
