"""The JAX package's numpy-only modules, loaded without its subpackages.

``dealii_slod_tpu/ops/__init__.py`` and ``dealii_slod_tpu/models/
__init__.py`` import the JAX kernels and solver, so even
``import dealii_slod_tpu.ops.element`` loads jax.  The numpy-only files the
port shares with the reference (the Q1 element tensors and the
coefficient-field samplers) are therefore loaded here from their paths,
under private module names: the port uses the reference's exact code and
never imports jax.  (``dealii_slod_tpu.config`` and ``dealii_slod_tpu.grid``
import normally: the package's own ``__init__`` loads only those two.)"""

from __future__ import annotations

import importlib.util
import os
import sys

import dealii_slod_tpu


def _load(relpath: str, name: str):
    path = os.path.join(os.path.dirname(dealii_slod_tpu.__file__), relpath)
    full = f"{__name__}.{name}"
    spec = importlib.util.spec_from_file_location(full, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[full] = module        # dataclasses resolve their module
    spec.loader.exec_module(module)
    return module


element = _load("ops/element.py", "element")
coefficients = _load("models/coefficients.py", "coefficients")
