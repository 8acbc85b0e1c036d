"""Atomic, async checkpointing of state trees, in the JAX package's format.

Layout (the same files the JAX package writes, so each package restores
the other's snapshots)::

    <dir>/step_<N>/
        manifest.json      # step, num_hosts, flat keys, shapes, dtypes
        host0.npz          # every leaf, flat-keyed

Flat keys are the JAX package's tree paths joined by ``/``: a NamedTuple
field is ``.name``, a dict key its ``str``, a list or tuple item its
index — ``.app/.store``, ``.decode/.k_pages``, ``engine/.req/.tail``,
``cold/k``. Dict keys are visited sorted, as JAX does, and ``None`` is an
empty subtree. bf16 leaves are stored as ``<key>::bf16`` uint16 views, and
the manifest's dtype strings are the ones JAX writes (JAX runs with 32-bit
defaults, so a 64-bit leaf is listed as its 32-bit type; the npz keeps the
64-bit bytes).

Commit protocol: write into ``step_<N>.tmp`` then ``os.rename`` — a crashed
save never shadows the last good checkpoint (``latest_step(
clean_stale_files=True)`` also removes torn ``.tmp`` leftovers).
:class:`AsyncCheckpointer` runs flush work on one background thread, one
flush outstanding; the durability tier (``fault.recovery``) overlaps its
snapshot and WAL writes with the engine step through it.

Between snapshots the durability tier may persist *delta* records —
``wal_<N>.npz`` files under the same tmp→rename protocol (``save_delta`` /
``list_deltas`` / ``load_delta``; the streamed segment log of
``checkpoint.wal`` is the default).

Host representation: leaves read back from disk are CPU tensors (numpy
has no bfloat16); :func:`host_copy` makes the owned CPU copy of a device
tree that a flush hands to the worker. The port's commits write device
state IN PLACE, so the copy must own its memory: a new page-locked
buffer for a CUDA tensor, filled by a synchronous device-to-host copy
that has finished when it returns, or ``.to("cpu", copy=True)``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

BF16_TAG = "::bf16"
# JAX's dtype names for 64-bit leaves with its 32-bit defaults
_JAX_DTYPE_NAME = {"int64": "int32", "uint64": "uint32", "float64": "float32",
                   "complex128": "complex64"}


# ---------------------------------------------------------------------------
# Trees: NamedTuples, dicts, lists/tuples; leaves are tensors or arrays
# ---------------------------------------------------------------------------

def _children(node):
    """``[(key, child), ...]`` of an interior node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", v) for f, v in zip(node._fields, node)]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _rebuilt(node, values):
    if node is None:
        return None
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*values)
    if isinstance(node, dict):
        return dict(zip(sorted(node), values))
    return type(node)(values)


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to every leaf, structure kept."""
    kids = _children(tree)
    if kids is None:
        return fn(tree)
    return _rebuilt(tree, [tree_map(fn, v) for _, v in kids])


# The walks below are module functions, not closures: a recursive closure
# is a reference cycle (the function and its own cell) that would keep the
# whole flat dict — a multi-GB host copy — alive until the cyclic garbage
# collector happens to run.

def _flatten_into(node, path, flat) -> None:
    kids = _children(node)
    if kids is None:
        flat["/".join(path)] = node
        return
    for k, v in kids:
        _flatten_into(v, path + [k], flat)


def _flatten(tree) -> dict[str, Any]:
    """Leaves keyed by their JAX-style path, in JAX's leaf order."""
    flat: dict[str, Any] = {}
    _flatten_into(tree, [], flat)
    return flat


def _rebuild(node, path, flat):
    kids = _children(node)
    if kids is None:
        return flat["/".join(path)]
    return _rebuilt(node, [_rebuild(v, path + [k], flat) for k, v in kids])


def rebuild(like, flat: dict[str, Any]):
    """Unflatten a ``_flatten``-keyed dict back into ``like``'s structure."""
    return _rebuild(like, [], flat)


def _host_leaf(x):
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            # page-locked, from the caching host allocator: the blocks of
            # earlier copies are reused, and the copy runs at the link's
            # rate instead of staging through pageable memory
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return out.copy_(x.detach())
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


def host_copy(tree):
    """An owned CPU copy of every leaf of ``tree`` (tensors stay tensors).
    From the card it is synchronous: it has finished when this returns."""
    return tree_map(_host_leaf, tree)


def np_bits(x) -> tuple[np.ndarray, bool]:
    """``(numpy array, is_bf16)`` for a tensor or array leaf: bf16 comes
    back as its uint16 bits, everything else as itself (no copy on the
    CPU)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 (a JAX array)
        return a.view(np.uint16), True
    return a, False


def from_bits(a: np.ndarray, bf16: bool = False,
              copy: bool = True) -> torch.Tensor:
    """A CPU tensor of ``a``'s bits (uint16 bits -> bfloat16), owning a
    copy unless ``copy`` is False (``a`` is then a fresh, writable array
    the tensor takes over)."""
    if copy:
        a = np.array(a, copy=True)
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def shape_of(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def dtype_name(x) -> str:
    """The dtype string the JAX package writes into a manifest."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
    else:
        name = np.asarray(x).dtype.name
    return _JAX_DTYPE_NAME.get(name, name)


# ---------------------------------------------------------------------------
# Snapshots
# ---------------------------------------------------------------------------

def save(directory: str, step: int, tree, host_id: int = 0,
         num_hosts: int = 1) -> str:
    """Synchronous save + atomic commit (host 0 commits)."""
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    arrays = {}
    for k, v in flat.items():
        a, bf16 = np_bits(v)
        arrays[k + BF16_TAG if bf16 else k] = a
    np.savez(os.path.join(tmp, f"host{host_id}.npz"), **arrays)
    if host_id == 0:
        manifest = {
            "step": step,
            "num_hosts": num_hosts,
            "keys": list(flat.keys()),
            "shapes": {k: list(shape_of(v)) for k, v in flat.items()},
            "dtypes": {k: dtype_name(v) for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """One outstanding async flush; ``wait()`` before the next or at exit.

    ``submit`` runs any host-side flush callable on the single background
    worker thread (the durability tier submits full snapshots and WAL
    writes through it). ``save`` copies the tree to the host synchronously
    (so the device state may change right after) and serializes it on the
    worker."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def submit(self, work) -> None:
        """Run ``work()`` on the background thread after joining the
        previous one; its exception (if any) surfaces on the next wait()."""
        self.wait()

        def runner():
            try:
                work()
            except BaseException as e:  # re-raised by the next wait()
                self._err = e

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()

    def save(self, step: int, tree) -> None:
        host_tree = host_copy(tree)
        self.submit(lambda: save(self.directory, step, host_tree))

    def busy(self) -> bool:
        """True while the previous flush is still running (submit would
        block)."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def clean_stale(directory: str) -> list[str]:
    """Remove torn flush leftovers: ``step_*.tmp`` dirs (a snapshot was
    being written when the process died) and ``wal_*.npz.tmp`` files (a
    torn delta). Returns the names removed. Committed state is never named
    ``*.tmp``."""
    removed = []
    if not os.path.isdir(directory):
        return removed
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if name.startswith("step_") and name.endswith(".tmp") \
                and os.path.isdir(path):
            shutil.rmtree(path)
            removed.append(name)
        elif name.startswith("wal_") and name.endswith(".npz.tmp") \
                and os.path.isfile(path):
            os.remove(path)
            removed.append(name)
    return removed


def latest_step(directory: str,
                clean_stale_files: bool = False) -> Optional[int]:
    """Largest committed snapshot step, or None. A leftover ``step_N.tmp``
    is never a candidate; with ``clean_stale_files=True`` such leftovers
    (and torn ``wal_*.npz.tmp``) are deleted first (the restart path)."""
    if not os.path.isdir(directory):
        return None
    if clean_stale_files:
        clean_stale(directory)
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# One-file delta records (the legacy WAL path)
# ---------------------------------------------------------------------------

def save_delta(directory: str, step: int, arrays: dict, meta: dict) -> str:
    """Atomically commit one delta record covering engine step ``step``:
    ``wal_<step>.npz.tmp`` written, fsynced and renamed. ``arrays`` is a
    flat dict of tensors or arrays (bf16 stored as ``::bf16`` bits),
    ``meta`` a flat dict of ints."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"wal_{step}.npz")
    tmp = final + ".tmp"
    meta_keys = sorted(meta)
    payload = {}
    for k, v in arrays.items():
        a, bf16 = np_bits(v)
        payload[k + BF16_TAG if bf16 else k] = a
    payload["__meta_keys__"] = np.array(meta_keys, dtype=np.str_)
    payload["__meta_vals__"] = np.array([int(meta[k]) for k in meta_keys],
                                        dtype=np.int64)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    return final


def list_deltas(directory: str) -> list[int]:
    """Sorted steps of committed delta records (``.tmp`` never listed)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("wal_") and name.endswith(".npz"):
            steps.append(int(name[len("wal_"):-len(".npz")]))
    return sorted(steps)


def _untag(k: str, a: np.ndarray) -> tuple[str, torch.Tensor]:
    """A member read from an npz (a fresh array) as a CPU tensor."""
    if k.endswith(BF16_TAG):
        return k[:-len(BF16_TAG)], from_bits(a, bf16=True, copy=False)
    return k, from_bits(a, copy=False)


def load_delta(directory: str, step: int) -> tuple[dict, dict[str, int]]:
    """One committed delta record -> (arrays as CPU tensors, meta)."""
    with np.load(os.path.join(directory, f"wal_{step}.npz")) as z:
        meta_keys = [str(k) for k in z["__meta_keys__"]]
        meta = {k: int(v) for k, v in zip(meta_keys, z["__meta_vals__"])}
        arrays = dict(_untag(k, z[k]) for k in z.files
                      if not k.startswith("__meta_"))
    return arrays, meta


def restore(directory: str, step: int, like, shardings=None, *,
            device=None):
    """Load snapshot ``step`` into the structure of ``like`` (a tree of
    tensors, or meta tensors, of the saved geometry). Each leaf is built
    on ``device`` if given, else on the device of ``like``'s leaf: the
    card for a meta leaf (pass ``device="cpu"`` for the host), the CPU
    where the leaf is not a tensor. It owns its memory and has the dtype
    it was saved with. Returns (tree, step).

    ``shardings`` (elastic restore): a matching tree of
    ``sharding.NamedSharding`` for the TARGET mesh, or None. The snapshot
    holds full logical arrays, so each leaf becomes this rank's block of
    its array under the new spec, whatever mesh saved it."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data: dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as z:
                data.update(_untag(k, z[k]) for k in z.files)
    flat_like = _flatten(like)
    missing = set(flat_like) - set(data)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    flat_sh = _flatten(shardings) if shardings is not None else {}
    out = {}
    for k, proto in flat_like.items():
        t = data[k]
        if tuple(t.shape) != tuple(shape_of(proto)):
            raise ValueError(f"shape mismatch for {k}: {tuple(t.shape)} vs "
                             f"{tuple(shape_of(proto))}")
        if flat_sh.get(k) is not None:
            t = flat_sh[k].block(t).clone()
        dev = device
        if dev is None and isinstance(proto, torch.Tensor):
            dev = "cuda" if proto.is_meta else proto.device
        out[k] = t if dev is None else t.to(dev)
    return rebuild(like, out), manifest["step"]
