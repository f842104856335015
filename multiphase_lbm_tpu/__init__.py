"""Multiphase lattice-Boltzmann framework in JAX.

A ground-up JAX/XLA re-design with the capabilities of the CooLBM
multiphase CPU modules (AmooMaD/Multiphase-LBM): D2Q9/D3Q19 BGK and MRT,
Shan–Chen single-component pseudopotential multiphase, conservative (Fakhari)
and HCZ phase-field solvers, a deformable-vessel hemodynamics module, and a
reactive multicomponent MRT combustion solver — with masks/coefficient-field
boundary conditions, fused collide–stream steps under ``jax.lax.scan``,
and ``shard_map`` halo-exchange multi-device scaling.
"""

__version__ = "0.1.0"

from .core import lattice, streaming, stencil, collision, eos  # noqa: F401
