"""Weight files, and checkpoint / resume of the tracker and the NeRF map.

A file stores a tree of arrays under dotted keys (e.g.
``params.feature_net.conv1.kernel``, ``state.idepths``) in an ``.npz``,
with an optional ``<file>.json`` sidecar of metadata, as the JAX
package's ``utils/checkpoint.py`` does.  bf16 tensors, which numpy lacks,
are stored as their int16 bit patterns and listed under the sidecar's
``"bfloat16"`` key.

``save_frontend`` / ``load_frontend`` and ``save_nerf`` / ``load_nerf``
store everything the next call reads, so a tracker or a field loaded into
a fresh instance of the same configuration continues as the saved one
would have, to the bit.  The tensor names are the port's; a file written
by the JAX package does not load here (weights cross over through
``models/convert.py`` and ``fusion/ngp.py``'s ``load_ngp_params``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch


def load_arrays(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """(flat arrays, sidecar metadata or {})."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return data, meta


def select(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """The entries under ``prefix`` (e.g. ``"params."``), prefix removed."""
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _flatten(tree, prefix=""):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip("."): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def save_arrays(path: str, tree: Any, meta: Dict = None):
    """Every tensor or array leaf of ``tree`` under its dotted key, host
    copies, uncompressed (a tracker's correlation volumes are large), and
    ``meta`` as the JSON sidecar."""
    arrays, bf16 = {}, []
    for k, v in _flatten(tree).items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                v = v.view(torch.int16)
                bf16.append(k)
            arrays[k] = v.numpy()
        elif isinstance(v, np.ndarray):
            arrays[k] = v
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    meta = dict(meta or {})
    if bf16:
        meta["bfloat16"] = bf16
    with open(path + ".json", "w") as f:
        json.dump(meta, f, default=float)    # numpy scalars as floats


def _tensor(flat, meta, key: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(flat[key]))
    if key in meta.get("bfloat16", ()):
        t = t.view(torch.bfloat16)
    return t.to(device)


def _load_dataclass(obj, flat, meta, prefix: str, device):
    """A copy of dataclass ``obj`` with every tensor field (lists of
    tensors too) read from ``flat`` under ``prefix``."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if isinstance(v, list):
            kw[f.name] = [_tensor(flat, meta, f"{key}.{i}", device)
                          for i in range(len(v))]
        else:
            kw[f.name] = _tensor(flat, meta, key, device)
    return type(obj)(**kw)


def _scalar(v):
    """A JSON value of a host number, a device scalar, or None."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return float(v)
    return v


_GRAPH_FIELDS = ("ii", "jj", "age", "ii_inactive", "jj_inactive", "ii_bad",
                 "jj_bad")


def save_frontend(path: str, frontend) -> None:
    """Snapshot a RaftVisualFrontend: pending edge maintenance settled,
    then the keyframe, edge and inactive-edge buffers, the graph, the
    frame/keyframe maps and every counter the next call reads."""
    frontend._flush_pending()
    g = frontend.graph
    meta = {
        "kf_idx": frontend.kf_idx,
        "last_kf_idx": frontend.last_kf_idx,
        "last_k": frontend.last_k,
        "is_initialized": frontend.is_initialized,
        "stop": frontend.stop,
        "kf_idx_to_f_idx": {str(k): v for k, v in
                            frontend.kf_idx_to_f_idx.items()},
        "graph": {name: getattr(g, name).tolist() for name in _GRAPH_FIELDS},
        "last_kf_dist": _scalar(frontend.last_kf_dist),
        "last_motion_mag": _scalar(frontend.last_motion_mag),
        "last_flow_rms": _scalar(frontend.last_flow_rms),
        "last_gba_scores": (None if frontend.last_gba_scores is None
                            else list(frontend.last_gba_scores)),
    }
    save_arrays(path, {"state": frontend.state, "edges": frontend.edges,
                       "inactive": frontend.inactive,
                       "viz_idx": frontend.viz_idx}, meta)


def load_frontend(path: str, frontend) -> None:
    """Restore into a frontend built with the same configuration and image
    size."""
    flat, meta = load_arrays(path)
    dev = frontend.device
    frontend.reset()
    frontend.state = _load_dataclass(frontend.state, flat, meta, "state.",
                                     dev)
    frontend.edges = _load_dataclass(frontend.edges, flat, meta, "edges.",
                                     dev)
    frontend.inactive = _load_dataclass(frontend.inactive, flat, meta,
                                        "inactive.", dev)
    frontend.viz_idx = flat["viz_idx"].astype(bool)
    for name in ("kf_idx", "last_kf_idx", "last_k", "is_initialized",
                 "stop", "last_kf_dist", "last_motion_mag", "last_flow_rms"):
        setattr(frontend, name, meta[name])
    if meta["last_kf_dist"] is None:
        frontend.last_kf_dist = float("inf")
    scores = meta["last_gba_scores"]
    frontend.last_gba_scores = None if scores is None else tuple(scores)
    frontend.kf_idx_to_f_idx = {int(k): v for k, v in
                                meta["kf_idx_to_f_idx"].items()}
    frontend.f_idx_to_kf_idx = {v: int(k) for k, v in
                                meta["kf_idx_to_f_idx"].items()}
    for name in _GRAPH_FIELDS:
        setattr(frontend.graph, name,
                np.asarray(meta["graph"][name], np.int64))


def save_nerf(path: str, fusion) -> None:
    """Snapshot a NerfFusion: the field, both Adam states, the training
    set, the pose deltas, the ray generator's state, the occupancy grid
    and the counters."""
    tree = {"field": fusion.field.state_dict(),
            "opt_state": fusion.opt.state_dict()["state"],
            "pose_deltas": fusion.pose_deltas,
            "pose_opt_state": fusion.pose_opt.state_dict()["state"],
            "train_set": fusion.train_set,
            "gen_state": fusion.gen.get_state()}
    if fusion._occ_mask is not None:
        tree["occ_mask"] = fusion._occ_mask
    save_arrays(path, tree, {
        "iteration": fusion.iteration, "has_data": fusion.has_data,
        "sigma_thresh": fusion.sigma_thresh, "occ_iter": fusion._occ_iter,
        "results": fusion.results})


def _load_opt(opt, flat, meta, prefix: str, device) -> None:
    sd = opt.state_dict()
    state = {}
    for key in flat:
        if key.startswith(prefix):
            idx, name = key[len(prefix):].split(".", 1)
            t = _tensor(flat, meta, key, "cpu")
            state.setdefault(int(idx), {})[name] = \
                t if name == "step" else t.to(device)
    sd["state"] = state
    opt.load_state_dict(sd)


def load_nerf(path: str, fusion) -> None:
    """Restore into a NerfFusion built with the same configuration."""
    flat, meta = load_arrays(path)
    dev = fusion.device
    fusion.field.load_state_dict(
        {k: _tensor(flat, meta, "field." + k, dev)
         for k in fusion.field.state_dict()})
    with torch.no_grad():
        fusion.pose_deltas.copy_(_tensor(flat, meta, "pose_deltas", dev))
    _load_opt(fusion.opt, flat, meta, "opt_state.", dev)
    _load_opt(fusion.pose_opt, flat, meta, "pose_opt_state.", dev)
    fusion.train_set = _load_dataclass(fusion.train_set, flat, meta,
                                       "train_set.", dev)
    fusion.gen.set_state(_tensor(flat, meta, "gen_state", "cpu"))
    fusion._occ_mask = (_tensor(flat, meta, "occ_mask", dev)
                        if "occ_mask" in flat else None)
    fusion._occ_iter = meta["occ_iter"]
    fusion.iteration = meta["iteration"]
    fusion.has_data = meta["has_data"]
    fusion.sigma_thresh = meta["sigma_thresh"]
    fusion.results = list(meta["results"])
