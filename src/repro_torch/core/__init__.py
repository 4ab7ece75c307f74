"""repro_torch.core — the paper's joins (the partitioned hash join, pk_fk and
m:n, the sort-merge join and the non-partitioned hash join, with GFTR and
GFUR materialization, and join sequences), the fused group-join, the five
group-by strategies, and the checked drivers that run them on the
escalation ladder, on PyTorch tensors."""

from . import primitives
from .groupby import (choose_groupby_partition_bits, choose_groupby_strategy, group_aggregate,
                      groupby_partition, groupby_partition_checked, groupby_partition_hash,
                      groupby_partition_overflowed, groupby_scatter, groupby_sort,
                      groupby_sort_pallas)
from .groupjoin import (groupjoin_checked, groupjoin_overflowed, groupjoin_required_groups,
                        phj_groupjoin)
from .hash_join import choose_partition_bits, hash32, phj_join, phj_join_checked, phj_overflowed
from .join import ALGORITHMS, PATTERNS, by_name, join, join_sequence
from .nphj import nphj_join
from .sort_merge import merge_find_mn, merge_find_pk_fk, smj_join
from .table import KEY_SENTINEL, Table, concat_tables, table_from_numpy, table_to_numpy

__all__ = [
    "Table", "table_from_numpy", "table_to_numpy", "concat_tables", "KEY_SENTINEL",
    "join", "join_sequence", "by_name", "ALGORITHMS", "PATTERNS",
    "smj_join", "merge_find_pk_fk", "merge_find_mn",
    "phj_join", "phj_join_checked", "phj_overflowed", "hash32",
    "choose_partition_bits", "nphj_join",
    "group_aggregate", "groupby_sort", "groupby_partition",
    "groupby_partition_checked", "groupby_partition_overflowed",
    "groupby_partition_hash", "groupby_scatter", "groupby_sort_pallas",
    "choose_groupby_strategy", "choose_groupby_partition_bits",
    "phj_groupjoin", "groupjoin_checked", "groupjoin_overflowed",
    "groupjoin_required_groups",
    "primitives",
]
