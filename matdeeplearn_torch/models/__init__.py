"""Model registry: build a model by its config name.

CGCNN, SchNet, MPNN and GCN are ported; the reference's other names raise
NotImplementedError that names their ROADMAP item.
"""

from __future__ import annotations

import torch

from matdeeplearn_torch.models.cgcnn import CGCNN
from matdeeplearn_torch.models.gcn import GCN
from matdeeplearn_torch.models.mpnn import MPNN
from matdeeplearn_torch.models.schnet import SchNet

MODEL_REGISTRY = {"CGCNN": CGCNN, "SchNet": SchNet, "MPNN": MPNN, "GCN": GCN}

# ROADMAP queue 1 items of the models still to port.
NOT_PORTED = {"MEGNet": "item 10", "SM": "item 12", "SOAP": "item 12"}

# Config fields each model takes (other YAML hyperparameters are ignored,
# as the reference forwards **kwargs, training.py:250-252).
_COMMON = {
    "num_features", "dim1", "dim2", "pre_fc_count", "gc_count",
    "post_fc_count", "pool", "pool_order", "batch_norm", "batch_track_stats",
    "act", "dropout_rate", "output_dim", "edge_resolution", "edge_width",
    "precision", "remat",
}
MODEL_FIELDS = {"CGCNN": _COMMON, "SchNet": _COMMON | {"dim3", "cutoff"},
                "MPNN": _COMMON | {"dim3"}, "GCN": _COMMON}


def build_model(name: str, dataset, hyperparams: dict, *,
                generator: torch.Generator | None = None,
                dropout_seed: int = 0,
                device: str | torch.device | None = None):
    """Instantiate a model by registry name with dataset-derived dims.

    Initial weights come from `generator`, dropout masks from a generator
    seeded with `dropout_seed`. String booleans ("True"/"False") are
    coerced, as in the reference's YAML. `precision` must be "f32" and
    `remat` false: bf16 and rematerialization are not ported yet.
    """
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name} is not ported yet (ROADMAP queue 1, {NOT_PORTED[name]})")
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model '{name}'; have {sorted(MODEL_REGISTRY)}")
    kwargs = {}
    for k, v in (hyperparams or {}).items():
        if k not in MODEL_FIELDS[name]:
            continue
        if k in ("batch_norm", "batch_track_stats", "remat") and isinstance(v, str):
            v = v == "True"
        kwargs[k] = v
    if str(kwargs.pop("precision", "f32")).lower() != "f32":
        raise NotImplementedError(
            "precision bf16 is not ported yet (ROADMAP queue 1, item 5)")
    if kwargs.pop("remat", False):
        raise NotImplementedError(
            "remat is not ported yet (ROADMAP queue 1, item 17)")
    kwargs.setdefault("output_dim", dataset.output_dim)
    kwargs.setdefault("num_features", dataset.num_features)
    kwargs.setdefault("edge_resolution", dataset.num_edge_features)
    kwargs.setdefault("edge_width", getattr(dataset, "edge_width", 0.2))
    return MODEL_REGISTRY[name](**kwargs, generator=generator,
                                dropout_seed=dropout_seed, device=device)
