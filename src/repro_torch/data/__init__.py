"""Synthetic data (twins of the reference's generators)."""
from .synthetic import (
    make_classification,
    make_regression,
    paper_dataset,
    shard_to_workers,
)

__all__ = ["make_classification", "make_regression", "paper_dataset",
           "shard_to_workers"]
