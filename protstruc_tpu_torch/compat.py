"""NumPy-echo compatibility layer (port of ``protstruc_tpu/compat.py``).

The reference's ``@with_tensor`` decorator (decorator.py:5-53) converts NumPy
inputs to torch tensors and converts results *back to NumPy iff no input was
a tensor* (its tests pin that type echo, tests/test_decorator.py:12-39).
:func:`with_array` is that decorator over the port's functions, plus
:data:`geometry`, the geometry module with every function wrapped.

    from protstruc_tpu_torch.compat import geometry as geom
    geom.dihedral(np_a, np_b, np_c, np_d)   # -> np.ndarray, computed on the card
"""

from __future__ import annotations

import functools
import types
from typing import Callable, Optional

import numpy as np
import torch

from protstruc_tpu_torch import geometry as _geometry

__all__ = ["with_array", "geometry"]


def _tensor_device(values) -> Optional[torch.device]:
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def _to_numpy(out):
    if isinstance(out, tuple):
        return tuple(_to_numpy(v) for v in out)
    if isinstance(out, list):
        return [_to_numpy(v) for v in out]
    if isinstance(out, dict):
        return {k: _to_numpy(v) for k, v in out.items()}
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return out


def with_array(fn: Optional[Callable] = None, *, device="cuda") -> Callable:
    """Echo NumPy: NumPy in, NumPy out; a tensor anywhere in, tensors out.

    NumPy arguments (positional or keyword) become tensors: on the device of
    the first tensor argument if there is one, else on ``device`` (default
    the card, which raises without one; pass ``device="cpu"`` for the host).
    If no argument or keyword value was a tensor, tensors in the result come
    back as NumPy, through tuple, list and dict outputs.  Usable as
    ``@with_array``, ``@with_array(device="cpu")`` or
    ``with_array(fn, device="cpu")``.
    """
    if fn is None:
        return functools.partial(with_array, device=device)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        from protstruc_tpu_torch.batch import resolve_device

        given = _tensor_device((*args, *kwargs.values()))
        dev = given

        def convert(x):
            nonlocal dev
            if not isinstance(x, np.ndarray):
                return x
            if dev is None:
                dev = resolve_device(device)
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        out = fn(*(convert(a) for a in args), **{k: convert(v) for k, v in kwargs.items()})
        return out if given is not None else _to_numpy(out)

    return wrapper


def _wrap_module(mod, names):
    out = types.ModuleType(f"{mod.__name__}.compat")
    for n in names:
        setattr(out, n, with_array(getattr(mod, n)))
    return out


#: geometry with the reference's NumPy echo (NumPy inputs computed on the card)
geometry = _wrap_module(_geometry, _geometry.__all__)
