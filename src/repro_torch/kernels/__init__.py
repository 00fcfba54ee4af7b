"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it in the same module:

* :mod:`.cubic_step` -- the batched Algorithm-2 solve, a thread block
  cluster a worker at any d (``csrc/cubic_solve.cu``), replacing the
  reference's Pallas ``cubic_step``;
* :mod:`.topk_compress` -- the batched top-|x| wire payload, one launch a
  call (:func:`topk_plan`): one warp per row up to d = 1408
  (``csrc/topk_compress.cu``) and a thread block cluster per row beyond
  (``csrc/topk_sharded.cu``), replacing the reference's Pallas
  ``topk_compress_tiled`` and ``topk_compress_sharded``;
* :mod:`.robust_agg` -- krum's scores (``csrc/krum_scores.cu``, tiled pair
  distances split over d, :func:`krum_plan`) and the per-coordinate worker
  sort behind the trimmed mean and the median (``csrc/sort_workers.cu``, a
  tile of columns sorted on chip, :func:`sort_plan`), up to m = 16384 on
  the card, replacing the reference's Pallas ``krum_scores_fused`` and
  ``sort_workers_fused``; and the sparse center
  (``csrc/sparse_agg.cu``, one launch at every d on the card, bit for bit
  the reference's sequential oracle), replacing the reference's Pallas
  ``aggregate_sparse_gridded`` and, on the card, its scatter branch;
* :mod:`.rmsnorm` -- RMSNorm over the last axis (``csrc/rmsnorm.cu``),
  replacing the reference's Pallas ``rmsnorm``;
* :mod:`.flash_attention` -- causal and sliding-window attention with an
  online softmax on the model's (B, S, H, Dh) layout
  (``csrc/flash_attention.cu``), replacing the reference's Pallas
  ``flash_attention`` behind ``ops.py::attention_bshd``.

A wrapper launches its kernel on a CUDA tensor, or raises; it runs the plain
version on a CPU tensor.  :data:`LAUNCHES` counts the kernel launches.
"""
from ._build import LAUNCHES, build_all, reset_launches
from .cubic_step import (
    CubicPlan,
    cubic_plan,
    cubic_solve,
    cubic_solve_fused,
    cubic_solve_plain,
    cubic_step,
    default_lr,
)
from .flash_attention import attention_bshd, attention_plain
from .rmsnorm import rmsnorm, rmsnorm_nd, rmsnorm_plain
from .robust_agg import (
    KRUM_MAX_M,
    SORT_MAX_M,
    SPARSE_SCATTER_MAX_D,
    KrumPlan,
    SortPlan,
    agg_kernel_plan,
    aggregate_sparse,
    aggregate_sparse_gridded,
    aggregate_sparse_plain,
    coordinate_median_fused,
    krum_plan,
    krum_scores,
    krum_scores_plain,
    krum_select_fused,
    sort_plan,
    sort_workers,
    sort_workers_plain,
    trimmed_mean_fused,
)
from .topk_compress import (
    SINGLE_TILE_MAX_D,
    TopkPlan,
    kernel_plan,
    topk_compress,
    topk_compress_plain,
    topk_compress_sharded,
    topk_decompress,
    topk_plan,
)

__all__ = [
    "CubicPlan",
    "KRUM_MAX_M",
    "KrumPlan",
    "LAUNCHES",
    "SINGLE_TILE_MAX_D",
    "SORT_MAX_M",
    "SPARSE_SCATTER_MAX_D",
    "SortPlan",
    "TopkPlan",
    "agg_kernel_plan",
    "aggregate_sparse",
    "aggregate_sparse_gridded",
    "aggregate_sparse_plain",
    "attention_bshd",
    "attention_plain",
    "build_all",
    "coordinate_median_fused",
    "cubic_plan",
    "cubic_solve",
    "cubic_solve_fused",
    "cubic_solve_plain",
    "cubic_step",
    "default_lr",
    "kernel_plan",
    "krum_plan",
    "krum_scores",
    "krum_scores_plain",
    "krum_select_fused",
    "reset_launches",
    "rmsnorm",
    "rmsnorm_nd",
    "rmsnorm_plain",
    "sort_plan",
    "sort_workers",
    "sort_workers_plain",
    "topk_compress",
    "topk_compress_plain",
    "topk_compress_sharded",
    "topk_decompress",
    "topk_plan",
    "trimmed_mean_fused",
]
