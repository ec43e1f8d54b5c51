"""Train-state checkpoints (port of ``protstruc_tpu/models/checkpoint.py``).

A step's state is one ``torch.save`` file, ``<directory>/<step>/state.pt``,
holding the model's parameters and the optimizer's state (moments, step
counts, EMA, accumulated gradients), all on the CPU.  The directory of a
step appears whole or not at all (written beside it, then renamed), so a
crash mid-save leaves the previous steps readable.  ``config.json`` lives in
``<directory>`` beside the steps, written by ``train``.  The JAX package's
orbax checkpoints are not read here (that needs jax); weights cross over
through ``convert.foldmodel_params_from_flax``.

A sharded model (``FoldModel(mesh=)``) holds its chunk of the tp-split
leaves: :func:`whole_state` gathers them over tp (every rank calls it), so a
checkpoint holds whole parameters whatever the mesh, and
:func:`load_whole_state` cuts a whole state dict for this rank's mesh.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["save_train_state", "restore_train_state", "latest_step", "all_steps", "gather_tp",
           "whole_state", "load_whole_state"]

_STATE = "state.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def gather_tp(tree: Dict[str, Any], specs: Dict[str, tuple], shard, device=None
              ) -> Dict[str, Any]:
    """``tree`` (name -> tensor, or name -> dict of tensors) with each
    tp-split leaf's chunks all-gathered over ``shard``'s tp group along its
    split dim (a collective over tp: every rank calls it, in the same
    order), moved to ``device`` first when given (NCCL gathers on the card);
    other leaves as they are."""
    from protstruc_tpu_torch.parallel.collectives import all_gather

    def whole(name, t):
        spec = specs.get(name, ())
        if "tp" not in spec or not torch.is_tensor(t) or t.dim() != len(spec):
            return t
        t = t.detach() if device is None else t.detach().to(device)
        return all_gather(t, spec.index("tp"), shard.tp_group)

    return {k: ({kk: whole(k, vv) for kk, vv in v.items()} if isinstance(v, dict) else whole(k, v))
            for k, v in tree.items()}


def _specs(model):
    from protstruc_tpu_torch.models.ipa import ipa_param_shardings

    return ipa_param_shardings(dict(model.named_parameters()))


def whole_state(model) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with a sharded model's tp chunks gathered
    whole (a collective over tp)."""
    sd = model.state_dict()
    if getattr(model, "shard", None) is None:
        return sd
    return gather_tp(sd, _specs(model), model.shard)


def load_whole_state(model, state: Dict[str, torch.Tensor]) -> None:
    """Load a whole state dict into ``model``, cut to a sharded model's
    chunks (``parallel.mesh.cut_params``)."""
    if getattr(model, "shard", None) is not None:
        from protstruc_tpu_torch.parallel.mesh import cut_params

        state = cut_params(state, _specs(model), model.shard.mesh)
    model.load_state_dict(state)


def save_train_state(directory: str, step: int, params: Dict[str, torch.Tensor],
                     opt_state: Dict[str, Any]) -> None:
    """Write ``params`` (a state_dict) and ``opt_state`` for ``step``."""
    final = os.path.join(directory, str(int(step)))
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"step": int(step), "params": _to_cpu(dict(params)),
                "opt_state": _to_cpu(opt_state)}, os.path.join(tmp, _STATE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)


def all_steps(directory: str) -> List[int]:
    """Sorted steps with a checkpoint under ``directory``."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(os.path.join(directory, n, _STATE)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_train_state(directory: str, step: Optional[int] = None,
                        map_location="cpu") -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], int]:
    """``(params, opt_state, step)`` of ``step`` (default: the latest)."""
    step = latest_step(directory) if step is None else int(step)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, str(step), _STATE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint for step {step} under {directory}")
    state = torch.load(path, map_location=map_location, weights_only=True)
    return state["params"], state["opt_state"], step
