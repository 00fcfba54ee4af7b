"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it in the same module:

* :mod:`.cubic_step` -- the batched Algorithm-2 solve (``csrc/cubic_solve.cu``),
  replacing the reference's Pallas ``cubic_step``;
* :mod:`.topk_compress` -- the batched top-|x| wire payload
  (``csrc/topk_compress.cu``), replacing the reference's Pallas
  ``topk_compress_tiled``;
* :mod:`.robust_agg` -- krum's scores (``csrc/krum_scores.cu``) and the
  per-coordinate worker sort behind the trimmed mean and the median
  (``csrc/sort_workers.cu``), replacing the reference's Pallas
  ``krum_scores_fused`` and ``sort_workers_fused``; and the sparse center's
  scatter branch (plain PyTorch, as in the reference).

A wrapper launches its kernel on a CUDA tensor, or raises; it runs the plain
version on a CPU tensor.  :data:`LAUNCHES` counts the kernel launches.
"""
from ._build import LAUNCHES, build_all, reset_launches
from .cubic_step import (
    cubic_solve,
    cubic_solve_fused,
    cubic_solve_plain,
    cubic_step,
    default_lr,
)
from .robust_agg import (
    SPARSE_SCATTER_MAX_D,
    aggregate_sparse,
    coordinate_median_fused,
    krum_scores,
    krum_scores_plain,
    krum_select_fused,
    sort_workers,
    sort_workers_plain,
    trimmed_mean_fused,
)
from .topk_compress import (
    SINGLE_TILE_MAX_D,
    topk_compress,
    topk_compress_plain,
    topk_decompress,
)

__all__ = [
    "LAUNCHES",
    "SINGLE_TILE_MAX_D",
    "SPARSE_SCATTER_MAX_D",
    "aggregate_sparse",
    "build_all",
    "coordinate_median_fused",
    "cubic_solve",
    "cubic_solve_fused",
    "cubic_solve_plain",
    "cubic_step",
    "default_lr",
    "krum_scores",
    "krum_scores_plain",
    "krum_select_fused",
    "reset_launches",
    "sort_workers",
    "sort_workers_plain",
    "topk_compress",
    "topk_compress_plain",
    "topk_decompress",
    "trimmed_mean_fused",
]
