"""repro_torch.serve — relational query serving: the plan cache with
capacity bucketing, cost-priced admission, the bytes ticket and
per-signature circuit breakers (`query`), and its soak harness (`chaos`),
DESIGN.md §14; and the LM stack's continuous-batching decode server
(`engine.ServeEngine`)."""
from .query import (CircuitBreaker, PlanEntry, QueryRequest, QueryServer, bucket_rows,
                    pad_table, plan_signature)

__all__ = ["CircuitBreaker", "PlanEntry", "QueryRequest", "QueryServer", "bucket_rows",
           "pad_table", "plan_signature"]
