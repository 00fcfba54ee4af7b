"""Workload configurations (copies of the reference's)."""
from .paper_workloads import PAPER_WORKLOADS, PaperWorkload

__all__ = ["PAPER_WORKLOADS", "PaperWorkload"]
