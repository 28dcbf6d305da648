"""Flat flax parameter keys -> PyTorch ``state_dict``.

The weight files (``weights_synthetic.npz``) hold flax parameters under
flat dotted keys, e.g. ``params.context_net.conv1.kernel`` (7, 7, 3, 32).
The port's modules keep the flax module names, so a key maps to
``context_net.conv1.weight`` with the kernel transposed: conv kernels
HWIO -> OIHW, dense kernels (in, out) -> (out, in).  This is the inverse
of the JAX package's droid.pth conversion (models/weights.py) and serves
both ``DroidNet`` and the NeRF ``PEField``; :func:`state_dict_to_flax`
is its inverse (the trainer writes its weights in the flax keys, so both
packages load them).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flax_to_state_dict(flat: Mapping[str, np.ndarray],
                       prefix: str = "params.") -> Dict[str, torch.Tensor]:
    """Flat flax keys (under ``prefix``) -> state_dict tensors (fp32)."""
    out = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        path, leaf = key[len(prefix):].rsplit(".", 1)
        v = np.array(value, np.float32)
        if leaf == "kernel":
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            elif v.ndim == 2:
                v = v.T
            name = f"{path}.weight"
        elif leaf == "bias":
            name = f"{path}.bias"
        else:
            raise KeyError(f"unexpected parameter leaf in {key!r}")
        out[name] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def state_dict_to_flax(sd: Mapping[str, torch.Tensor],
                       prefix: str = "params.") -> Dict[str, np.ndarray]:
    """``state_dict`` -> flat flax keys (f32 host arrays): the inverse of
    :func:`flax_to_state_dict`."""
    out = {}
    for name, t in sd.items():
        path, leaf = name.rsplit(".", 1)
        v = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if v.ndim == 4:
                v = v.transpose(2, 3, 1, 0)
            elif v.ndim == 2:
                v = v.T
            leaf = "kernel"
        elif leaf != "bias":
            raise KeyError(f"unexpected parameter leaf in {name!r}")
        out[f"{prefix}{path}.{leaf}"] = np.ascontiguousarray(v)
    return out


def load_flax_weights(module: torch.nn.Module,
                      flat: Mapping[str, np.ndarray],
                      prefix: str = "params.") -> torch.nn.Module:
    """Copy flat flax parameters into ``module`` (every parameter must be
    present; dtypes follow the module)."""
    sd = flax_to_state_dict(flat, prefix)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"weight keys differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    module.load_state_dict({k: v.to(own[k].dtype) for k, v in sd.items()})
    return module
