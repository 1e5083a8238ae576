"""Parameter trees: nested dicts of tensors with the JAX package's names.

``Initializer`` / ``StackedInit`` draw random weights from an explicit
``torch.Generator`` with the same tree, names, shapes and scales as
``repro.models.params.Initializer`` and the stacked layer init of
``repro.models.transformer`` (the numbers differ: the generators differ).
``params_from_numpy`` carries the JAX package's own parameters across.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


class Initializer:
    """Draws every leaf from one generator, in the order init code asks.

    Leaves are drawn on the generator's device in fp32 and then cast, so
    full-width weights are made on the card without a host copy."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def normal(self, shape: Tuple[int, ...], scale: float = 0.02) -> torch.Tensor:
        x = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.generator.device)
        return (x * scale).to(device=self.device, dtype=self.dtype)

    def fan_in(self, shape: Tuple[int, ...]) -> torch.Tensor:
        # variance-scaling on the second-to-last dim (input features)
        fan = shape[-2] if len(shape) >= 2 else shape[-1]
        return self.normal(shape, scale=1.0 / math.sqrt(fan))

    def zeros(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)


class StackedInit:
    """Prepends a leading layer dim to every shape; fan-in stays correct
    because ``Initializer.fan_in`` reads shape[-2]."""

    def __init__(self, inner: Initializer, n: int):
        self._inner, self._n = inner, n

    def normal(self, shape, scale: float = 0.02):
        return self._inner.normal((self._n,) + tuple(shape), scale)

    def fan_in(self, shape):
        return self._inner.fan_in((self._n,) + tuple(shape))

    def zeros(self, shape):
        return self._inner.zeros((self._n,) + tuple(shape))

    def ones(self, shape):
        return self._inner.ones((self._n,) + tuple(shape))


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16; widening to fp32 is exact
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Params, device="cpu") -> Params:
    """The JAX package's parameters as the port's tensors: ``tree`` is the
    nested dict of numpy arrays from ``jax.tree.map(np.asarray, params)``.
    Names, nesting, shapes and dtypes are kept."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _to_tensor(np.asarray(tree), device)
