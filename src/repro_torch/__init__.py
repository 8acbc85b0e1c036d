"""ORCA on PyTorch and CUDA: the port of the ``repro`` JAX package.

The layout mirrors ``repro``: ``core`` holds the request engine (rings,
cpoll, scheduler, engine step, the LM serving engine) and its apps,
``kernels`` the hand-written CUDA kernels for Hopper beside their plain
PyTorch versions, ``configs``/``models``/``serving``/``launch`` the LM
(dense family) and its paged KV pool. State is a
NamedTuple of tensors, passed in and returned, on an explicit device
(CUDA unless the caller asks for the CPU). This package imports ``torch``
and never JAX: ``interop`` moves states across as numpy arrays.
"""
