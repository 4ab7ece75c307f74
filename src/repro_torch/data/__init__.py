"""Workload generators returning numpy dicts (`table_from_numpy` puts them
on a device)."""
from .relgen import TPC_JOINS, JoinWorkload, generate, generate_star, generate_tpc

__all__ = ["JoinWorkload", "TPC_JOINS", "generate", "generate_star", "generate_tpc"]
