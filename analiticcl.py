"""Drop-in shim: ``import analiticcl`` resolves to the analiticcl_jax engine.

Place this repository on PYTHONPATH and existing analiticcl code runs
unchanged (same classes, kwargs, and dict result schemas — see
analiticcl_jax/api.py for the surface definition).
"""

from analiticcl_jax.api import (  # noqa: F401
    SearchParameters,
    VariantModel,
    VocabParams,
    Weights,
)

__all__ = ["VariantModel", "Weights", "SearchParameters", "VocabParams"]
