"""Checkpoint and resume of training and control runs.

Counterpart of detex_tpu/utils/checkpoint.py.  A checkpoint holds what a
deterministic resume needs: the dynamics parameters, the optimizer's
state dict, the MPPI nominal control sequence, the generator's state and
the step counter.  It is one file written by torch.save and read back by
torch.load(weights_only=True): a dict of tensors and plain values, so
loading it runs no pickled code.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import torch


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def controller_state(params, opt_state, nominal, generator_state,
                     step: int) -> Dict[str, Any]:
    """params: the parameter dict; opt_state: an optimizer's state_dict()
    (or None); nominal: (H, A) tensor; generator_state: a generator's
    get_state() (or None)."""
    return {"params": _detached(params), "opt_state": opt_state,
            "nominal": _detached(nominal), "generator": generator_state,
            "step": int(step)}


def save(path: str, state: Dict[str, Any]) -> None:
    """Write `state` to `path` (a file), replacing it whole: the new file
    is written beside it and renamed over it."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state, tmp)
    tmp.replace(path)


def restore(path: str, map_location=None) -> Dict[str, Any]:
    """Read a checkpoint written by save(); tensors come back on the
    device they were saved from unless map_location says otherwise."""
    return torch.load(path, map_location=map_location, weights_only=True)
