"""Checkpoints with the reference's auto-resume contract (counterpart of
``detikzify_tpu/train/checkpoint.py``).

The JAX package's layout stays: ``<output_dir>/checkpoint-<step>/`` holds
the state and a ``meta.json`` written after it, the marker that the save
finished, and only the newest ``max_to_keep`` checkpoints stay. The state
is one ``state.pt`` (``torch.save``): the parameters, the optimizer state
and the step, read back with ``torch.load(weights_only=True)``. Saves are
synchronous, so ``wait`` has nothing to wait for. ``save_params_npz``
writes the JAX tree's keys (``proj/kernel`` ``[in, out]``, ...), so a
projector file of either package loads in both.

On a mesh (``parallel.mesh.place_params``) every rank calls ``save`` and
``restore`` together: ``save`` gathers the whole leaves and moments and
rank 0 writes them in the same format, and ``restore`` gives each rank its
part again, whatever the mesh's shape was when the file was written.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.convert import leaves, params_to_numpy
from .step import TrainState

_STEP_RE = re.compile(r"^checkpoint-(\d+)$")


def _ckpt_dir(output_dir: str, step: int) -> str:
    return os.path.join(output_dir, f"checkpoint-{step}")


def get_last_checkpoint(output_dir: str) -> Optional[str]:
    """Latest ``checkpoint-<step>`` subdirectory, like HF's helper."""
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        m = _STEP_RE.match(name)
        if m and int(m.group(1)) > best_step:
            marker = os.path.join(output_dir, name, "meta.json")
            if os.path.exists(marker):
                best, best_step = os.path.join(output_dir, name), int(m.group(1))
    return best


class Checkpointer:
    def __init__(self, output_dir: str, max_to_keep: int = 3):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, step: int, state: Union[TrainState, nn.Module],
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Save a ``TrainState``, or a module's weights alone (the
        post-training loops save the part they train)."""
        path = _ckpt_dir(self.output_dir, step)
        if isinstance(state, nn.Module):
            self._write(path, step, {"params": state.state_dict(),
                                     "step": step}, meta)
            return path
        placement = getattr(state.params, "placement", None)
        if placement is None:
            self._write(path, step, {"params": state.params.state_dict(),
                                     "opt_state": state.opt_state,
                                     "step": state.step}, meta)
            return path
        with placement.gathered():
            opt_state = placement.gather_state(
                state.opt_state, {l.path: l for l in leaves(state.params)})
            if placement.rank == 0 and _process_rank() == 0:
                self._write(path, step, {"params": state.params.state_dict(),
                                         "opt_state": opt_state,
                                         "step": state.step}, meta)
        if placement.mesh.distributed:
            dist.barrier()
        return path

    def _write(self, path, step, blob, meta) -> None:
        os.makedirs(path, exist_ok=True)
        torch.save(blob, os.path.join(path, "state.pt"))
        # meta.json is the completeness marker get_last_checkpoint keys on:
        # written only once the state is on disk
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        self._gc()

    def restore(self, path: str, template: TrainState) -> TrainState:
        """Restore into ``template``: its parameters are overwritten in
        place (they keep their device and dtype); the optimizer state's
        tensors go to the device of the parameters."""
        params = template.params
        device = next(params.parameters()).device
        saved = torch.load(os.path.join(path, "state.pt"),
                           map_location=device, weights_only=True)
        placement = getattr(params, "placement", None)
        if placement is None:
            params.load_state_dict(saved["params"])
            return TrainState(params, saved["opt_state"], int(saved["step"]))
        with placement.gathered():
            params.load_state_dict(saved["params"])
            placement.refresh_masters()
        opt_state = placement.shard_state(
            saved["opt_state"], {l.path: l for l in leaves(params)})
        return TrainState(params, opt_state, int(saved["step"]))

    def restore_latest(self, template: TrainState):
        path = get_last_checkpoint(self.output_dir)
        if path is None:
            return None, None
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return self.restore(path, template), meta

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def _gc(self) -> None:
        steps = sorted(
            int(_STEP_RE.match(n).group(1))
            for n in os.listdir(self.output_dir) if _STEP_RE.match(n))
        for step in steps[:-self.max_to_keep]:
            shutil.rmtree(_ckpt_dir(self.output_dir, step),
                          ignore_errors=True)


def _process_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def save_params_npz(path: str, params, only: Optional[str] = None) -> None:
    """Flat .npz export of (a part of) params under the JAX tree's keys --
    the partial-state equivalent of the reference's projector-only save
    (pretrain.py:104-111). ``only``: one top-level part of ``Params``
    ('connector', 'vision', 'text')."""
    tree = params_to_numpy(getattr(params, only) if only else params)
    flat = {}

    def visit(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = node

    visit("", tree)
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
