"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: comparing whole states, and moving seeded numpy inputs across."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import interop


def assert_same(jax_obj, torch_obj, path="state"):
    """Every leaf of two states (NamedTuples, dicts or arrays) equal in
    dtype, shape and value, bit for bit."""
    a = interop.to_numpy(jax_obj)
    b = interop.to_numpy(torch_obj)
    _cmp(a, b, path)


def _cmp(a, b, path):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (
            f"{path}: fields {sorted(a)} vs {sorted(b) if isinstance(b, dict) else b}")
        for k in a:
            _cmp(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), f"{path}: lengths"
        for i, (x, y) in enumerate(zip(a, b)):
            _cmp(x, y, f"{path}[{i}]")
        return
    assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{path}: shape {a.shape} vs {b.shape}"
    if not np.array_equal(a, b):
        where = np.argwhere(a != b)[:5].tolist()
        raise AssertionError(f"{path}: values differ at {where}")


def t(x):
    """A CPU tensor holding a copy of numpy array ``x``."""
    return torch.from_numpy(np.array(x, copy=True))
