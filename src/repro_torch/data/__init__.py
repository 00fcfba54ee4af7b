"""Synthetic data (twins of the reference's generators)."""
from .synthetic import (
    TokenStream,
    make_classification,
    make_regression,
    paper_dataset,
    shard_to_workers,
)

__all__ = ["TokenStream", "make_classification", "make_regression",
           "paper_dataset", "shard_to_workers"]
