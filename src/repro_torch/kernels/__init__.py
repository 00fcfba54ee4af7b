"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it in the same module:

* :mod:`.cubic_step` -- the batched Algorithm-2 solve (``csrc/cubic_solve.cu``),
  replacing the reference's Pallas ``cubic_step``;
* :mod:`.topk_compress` -- the batched top-|x| wire payload: one CTA per
  row up to d = 1408 (``csrc/topk_compress.cu``) and a grid of row × block
  CTAs beyond (``csrc/topk_sharded.cu``), replacing the reference's Pallas
  ``topk_compress_tiled`` and ``topk_compress_sharded``;
* :mod:`.robust_agg` -- krum's scores (``csrc/krum_scores.cu``) and the
  per-coordinate worker sort behind the trimmed mean and the median
  (``csrc/sort_workers.cu``), replacing the reference's Pallas
  ``krum_scores_fused`` and ``sort_workers_fused``; and the sparse center:
  its scatter branch up to d = 4096 (plain PyTorch, as in the reference)
  and the gridded kernel beyond (``csrc/sparse_agg.cu``), replacing the
  reference's Pallas ``aggregate_sparse_gridded``;
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
    cubic_solve,
    cubic_solve_fused,
    cubic_solve_plain,
    cubic_step,
    default_lr,
)
from .flash_attention import attention_bshd, attention_plain
from .rmsnorm import rmsnorm, rmsnorm_nd, rmsnorm_plain
from .robust_agg import (
    SPARSE_SCATTER_MAX_D,
    agg_kernel_plan,
    aggregate_sparse,
    aggregate_sparse_gridded,
    aggregate_sparse_plain,
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
    kernel_plan,
    topk_compress,
    topk_compress_plain,
    topk_compress_sharded,
    topk_decompress,
)

__all__ = [
    "LAUNCHES",
    "SINGLE_TILE_MAX_D",
    "SPARSE_SCATTER_MAX_D",
    "agg_kernel_plan",
    "aggregate_sparse",
    "aggregate_sparse_gridded",
    "aggregate_sparse_plain",
    "attention_bshd",
    "attention_plain",
    "build_all",
    "coordinate_median_fused",
    "cubic_solve",
    "cubic_solve_fused",
    "cubic_solve_plain",
    "cubic_step",
    "default_lr",
    "kernel_plan",
    "krum_scores",
    "krum_scores_plain",
    "krum_select_fused",
    "reset_launches",
    "rmsnorm",
    "rmsnorm_nd",
    "rmsnorm_plain",
    "sort_workers",
    "sort_workers_plain",
    "topk_compress",
    "topk_compress_plain",
    "topk_compress_sharded",
    "topk_decompress",
    "trimmed_mean_fused",
]
