"""`repro_torch` -- the PyTorch and CUDA port of the `repro` reproduction.

A package of its own beside the JAX reference ``src/repro/``: it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Its layout
mirrors the reference's (``api/``, ``core/``, ``comm/``, ``compression/``,
``data/``, ``configs/``, ``kernels/``, ``models/``, ``launch/``), so each
module's counterpart is easy to find.  It runs the paper's Algorithm 1 in
the paper-faithful runtime (``core.newton.DistributedCubicNewton``), built
through ``api.ExperimentSpec.build(device=None)``, and serves the model
zoo's dense decoders (``models.build_model``, ``launch.serve``); entry
points default to the card and raise when none is present unless the
caller passes ``device="cpu"``.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
