"""What every kernel wrapper shares: argument checks, typed C entry points
of one ``csrc/`` library, launching on the current stream, and the launch
counts.

A wrapper takes CUDA tensors only (the dispatcher in ``ops`` sends CPU
tensors to the plain versions in ``ref``), checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream without
synchronising, and raises if the launch is refused. ``Library.launches``
counts, per kernel, the launches made since the last ``reset``: a wrapper
adds one where it launches and nowhere else, so a run can show that it
went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def check(name: str, t: torch.Tensor, ndim: int, device,
          dtype=torch.int32, contiguous: bool = True) -> None:
    """Raise unless ``t`` is an ``ndim``-d CUDA tensor of ``dtype`` (or of
    one of the dtypes in a tuple) on ``device``, contiguous unless
    ``contiguous`` is False."""
    if t.device.type != "cuda":
        raise ValueError(
            f"{name}: the CUDA kernel takes CUDA tensors, got {t.device} "
            "(CPU tensors go to the plain versions: backend auto or ref)"
        )
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected "
                        f"{' or '.join(str(d) for d in dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def same(name: str, got, want) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"{name}: shape {tuple(got)}, expected {tuple(want)}")


class Library:
    """The typed entry points of ``csrc/<name>.cu`` and the launch counts
    of its kernels. ``signatures`` maps each C entry point to its argument
    types, the trailing stream excluded."""

    def __init__(self, name: str, kernels, signatures: dict):
        self.name = name
        self.launches = dict.fromkeys(kernels, 0)
        self._signatures = signatures
        self._typed: dict = {}

    def reset(self) -> None:
        for k in self.launches:
            self.launches[k] = 0

    def _entry(self, entry: str):
        fn = self._typed.get(entry)
        if fn is None:
            fn = getattr(_build.load(self.name), entry)
            fn.argtypes = [*self._signatures[entry], P]
            fn.restype = ctypes.c_int
            self._typed[entry] = fn
        return fn

    def launch(self, kernel: str, entry: str, device, *args) -> None:
        """Launch ``entry`` on ``device``'s current stream, raise if CUDA
        refused it, and count one launch of ``kernel``."""
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            code = self._entry(entry)(*args, stream)
        _build.check(_build.load(self.name), code, f"{self.name}.{kernel}")
        self.launches[kernel] += 1
