"""Configurations: the paper's workloads and the model zoo's dense
decoders (copies of the reference's).

``get_config("<arch>")`` serves the dense configurations whose layers are
the ``G``/``L`` attention blocks only: gemma3-27b, codeqwen1.5-7b,
internlm2-20b, llama3-405b and its sliding-window variant.  The reference's
other architectures (MoE, SSM, hybrid, audio, VLM) raise
:class:`NotImplementedError` naming their ROADMAP.md item.
"""
from .base import INPUT_SHAPES, InputShape, ModelConfig
from .codeqwen15_7b import CONFIG as CODEQWEN15_7B
from .gemma3_27b import CONFIG as GEMMA3_27B
from .internlm2_20b import CONFIG as INTERNLM2_20B
from .llama3_405b import CONFIG as LLAMA3_405B, VARIANT_SWA as LLAMA3_405B_SWA
from .paper_workloads import PAPER_WORKLOADS, PaperWorkload

ARCHS = {c.name: c for c in (LLAMA3_405B, CODEQWEN15_7B, INTERNLM2_20B,
                             GEMMA3_27B)}
VARIANTS = {LLAMA3_405B_SWA.name: LLAMA3_405B_SWA}
#: the reference's architectures whose blocks the port does not have yet
NOT_PORTED = ("mamba2-780m", "internvl2-76b", "whisper-medium",
              "recurrentgemma-9b", "deepseek-moe-16b",
              "phi3.5-moe-42b-a6.6b")


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in VARIANTS:
        return VARIANTS[name]
    if name in NOT_PORTED:
        from ..api.errors import not_ported  # api imports configs

        raise not_ported(f"architecture {name!r}", "Queue 1 item 14")
    raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")


__all__ = [
    "ARCHS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "NOT_PORTED",
    "PAPER_WORKLOADS",
    "PaperWorkload",
    "VARIANTS",
    "get_config",
]
