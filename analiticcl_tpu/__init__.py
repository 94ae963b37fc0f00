"""Former import name of :mod:`analiticcl_jax`, kept so that existing imports
keep working: this package and each of its submodules are the very module
objects of ``analiticcl_jax`` (``<old name>.cli is analiticcl_jax.cli``)."""

import importlib
import pkgutil
import sys

import analiticcl_jax

for _m in pkgutil.walk_packages(analiticcl_jax.__path__, "analiticcl_jax."):
    sys.modules[__name__ + _m.name[len("analiticcl_jax"):]] = (
        importlib.import_module(_m.name)
    )
sys.modules[__name__] = analiticcl_jax
