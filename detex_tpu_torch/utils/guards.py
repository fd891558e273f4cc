"""Numerical-determinism guards.

Counterpart of detex_tpu/utils/guards.py.  Two kinds of guard on the
float paths:

  * ``checked(fn)`` runs fn under a TorchDispatchMode that looks at the
    floating-point output of every op and raises FloatingPointError,
    naming the op, on the first NaN or Inf; the analogue of checkify's
    float checks on every primitive.  Each op's check reads a flag back
    from the device, so it is for tests and DETEX_DEBUG_NANS=1 runs.
  * ``assert_all_finite(tree, name)``: an eager guard for host-side call
    sites (training loops between steps).

The integer decode kernels need no guards: they produce validity masks,
not exceptions.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def debug_nans_enabled() -> bool:
    return os.environ.get("DETEX_DEBUG_NANS", "") not in ("", "0")


class _FloatChecks(TorchDispatchMode):
    """Raise on the first op whose floating-point output is not finite."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"non-finite output of {func}")
        return out


def checked(fn):
    """Wrap fn so that any op inside it that produces a NaN or Inf
    raises FloatingPointError instead of propagating silently."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return wrapper


def maybe_checked(fn):
    """`checked(fn)` when DETEX_DEBUG_NANS=1, else `fn` untouched."""
    return checked(fn) if debug_nans_enabled() else fn


def _flatten_with_path(tree, path=""):
    """(path, leaf) pairs of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        return leaf.numpy()
    return np.asarray(leaf)


def assert_all_finite(tree, name: str = "value") -> None:
    """Host-side guard: raise FloatingPointError if any floating-point
    leaf (tensor or array) holds NaN or Inf."""
    for path, leaf in _flatten_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and \
                not bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = np.issubdtype(arr.dtype, np.floating) and \
                not np.all(np.isfinite(arr))
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")


def tree_equal(a, b) -> bool:
    """Bitwise equality of two nested structures of tensors and arrays
    (determinism checks: same seed -> identical results)."""
    la, lb = list(_flatten_with_path(a)), list(_flatten_with_path(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        xa, ya = _numpy(x), _numpy(y)
        if xa.dtype != ya.dtype or xa.shape != ya.shape:
            return False
        if not np.array_equal(np.ascontiguousarray(xa).view(np.uint8),
                              np.ascontiguousarray(ya).view(np.uint8)):
            return False
    return True
