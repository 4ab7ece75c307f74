"""repro_torch.core — the paper's partitioned hash join with GFTR
materialization and the partition group-by, on PyTorch tensors."""

from . import primitives
from .groupby import choose_groupby_partition_bits, group_aggregate, groupby_partition
from .hash_join import choose_partition_bits, hash32, phj_join, phj_overflowed
from .join import ALGORITHMS, PATTERNS, by_name, join
from .table import KEY_SENTINEL, Table, concat_tables, table_from_numpy, table_to_numpy

__all__ = [
    "Table", "table_from_numpy", "table_to_numpy", "concat_tables", "KEY_SENTINEL",
    "join", "by_name", "ALGORITHMS", "PATTERNS",
    "phj_join", "phj_overflowed", "hash32", "choose_partition_bits",
    "group_aggregate", "groupby_partition", "choose_groupby_partition_bits",
    "primitives",
]
