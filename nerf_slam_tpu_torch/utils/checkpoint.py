"""Reading the flat-key ``.npz`` weight files (numpy).

A file stores a parameter tree under dotted keys, e.g.
``params.feature_net.conv1.kernel``, with an optional ``<file>.json``
sidecar of metadata (the weights' BA damping recipe, for one).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np


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
