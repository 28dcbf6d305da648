"""Pretrained-weight conversion: DROID's ``droid.pth`` -> ``DroidNet``.

The reference checkpoint names its modules ``module.fnet.layer1.0.conv1``,
``module.update.corr_encoder.0`` and so on; the port's modules keep the
JAX package's names (``feature_net.layer1_0.conv1``,
``update_net.corr_encoder_0``).  ``normalize_keys`` strips the
``module.`` prefix, renames ``fnet``/``cnet``/``update`` and truncates the
flow-delta and weight heads to 2 output channels, as the JAX package's
converter does; the sequential indices then become the port's names.
Both sides are OIHW, so no tensor is transposed.  :func:`to_reference`
names a ``DroidNet`` state_dict as the reference checkpoint does (with
2-channel heads).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import torch


def normalize_keys(state: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in state.items():
        k = k.replace("module.", "")
        k = k.replace("fnet.", "feature_net.")
        k = k.replace("cnet.", "context_net.")
        if k.startswith("update."):
            k = k.replace("update.", "update_net.", 1)
        out[k] = torch.as_tensor(v)
    # truncate the flow-delta / weight heads to 2 channels
    for head in ("update_net.weight.2", "update_net.delta.2"):
        wk, bk = head + ".weight", head + ".bias"
        if wk in out:
            out[wk] = out[wk][:2]
            out[bk] = out[bk][:2]
    return out


# reference module path -> the port's (and the JAX package's) module path
_SEQ_RENAMES = [
    (re.compile(r"^(feature_net|context_net)\.layer(\d)\.(\d)\."),
     r"\1.layer\2_\3."),
    (re.compile(r"\.downsample\.0\."), ".downsample."),
    (re.compile(r"^update_net\.(corr_encoder|flow_encoder|weight|delta)"
                r"\.(\d)\."), r"update_net.\1_\2."),
    (re.compile(r"^update_net\.agg\.(eta|upmask)\.0\."),
     r"update_net.agg.\1_0."),
]


def torch_key_to_port_key(key: str) -> str:
    """'feature_net.layer1.0.conv1.weight' ->
    'feature_net.layer1_0.conv1.weight'"""
    for pat, rep in _SEQ_RENAMES:
        key = pat.sub(rep, key)
    return key


def convert(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Reference ``state_dict`` -> the port's ``DroidNet`` state_dict
    (f32, contiguous)."""
    return {torch_key_to_port_key(k): v.to(torch.float32).contiguous()
            for k, v in normalize_keys(state).items()}


_REF_RENAMES = [
    (re.compile(r"^(feature_net|context_net)\.layer(\d)_(\d)\."),
     r"\1.layer\2.\3."),
    (re.compile(r"\.downsample\."), ".downsample.0."),
    (re.compile(r"^update_net\.(corr_encoder|flow_encoder|weight|delta)"
                r"_(\d)\."), r"update_net.\1.\2."),
    (re.compile(r"^update_net\.agg\.(eta|upmask)_0\."),
     r"update_net.agg.\1.0."),
    (re.compile(r"^feature_net\."), "module.fnet."),
    (re.compile(r"^context_net\."), "module.cnet."),
    (re.compile(r"^update_net\."), "module.update."),
]


def to_reference(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``DroidNet`` state_dict under the reference checkpoint's names
    (``module.fnet.layer1.0.conv1.weight``, ...): :func:`convert` maps it
    back."""
    out = {}
    for k, v in sd.items():
        for pat, rep in _REF_RENAMES:
            k = pat.sub(rep, k)
        out[k] = v
    return out


def load_droid_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``droid.pth`` checkpoint (tensors only) as a ``DroidNet``
    state_dict."""
    return convert(torch.load(path, map_location="cpu", weights_only=True))
