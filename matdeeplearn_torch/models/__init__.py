"""Model registry: build a model by its config name.

All seven of the reference's models: the GNNs CGCNN, SchNet, MPNN, GCN
and MEGNet, and the descriptor MLPs SM and SOAP (models/descriptor_nn.py),
whose input width is the dataset's descriptor width.
"""

from __future__ import annotations

import torch

from matdeeplearn_torch.models.base import check_precision
from matdeeplearn_torch.models.cgcnn import CGCNN
from matdeeplearn_torch.models.descriptor_nn import SM, SOAP
from matdeeplearn_torch.models.gcn import GCN
from matdeeplearn_torch.models.megnet import MEGNet
from matdeeplearn_torch.models.mpnn import MPNN
from matdeeplearn_torch.models.schnet import SchNet

MODEL_REGISTRY = {"CGCNN": CGCNN, "SchNet": SchNet, "MPNN": MPNN, "GCN": GCN,
                  "MEGNet": MEGNet, "SM": SM, "SOAP": SOAP}
# the models over whole-structure descriptors (batch.extra)
DESCRIPTOR_MODELS = ("SM", "SOAP")

# Config fields each model takes (other YAML hyperparameters are ignored,
# as the reference forwards **kwargs, training.py:250-252).
_COMMON = {
    "num_features", "dim1", "dim2", "pre_fc_count", "gc_count",
    "post_fc_count", "pool", "pool_order", "batch_norm", "batch_track_stats",
    "act", "dropout_rate", "output_dim", "edge_resolution", "edge_width",
    "precision", "remat",
}
MODEL_FIELDS = {"CGCNN": _COMMON, "SchNet": _COMMON | {"dim3", "cutoff"},
                "MPNN": _COMMON | {"dim3"}, "GCN": _COMMON,
                "MEGNet": _COMMON | {"dim3", "gc_fc_count"},
                "SM": {"dim1", "fc_count", "output_dim", "precision"},
                "SOAP": {"dim1", "fc_count", "output_dim", "precision"}}


def descriptor_width(dataset) -> int:
    """The width of the dataset's single descriptor entry (SOAP or SM)."""
    extras = getattr(dataset, "extra_features", None) or {}
    if len(extras) != 1:
        raise ValueError(
            "descriptor models need extra features; enable SOAP_descriptor/"
            "SM_descriptor in Processing config")
    return int(next(iter(extras.values())).shape[1])


def build_model(name: str, dataset, hyperparams: dict, *,
                generator: torch.Generator | None = None,
                dropout_seed: int = 0,
                device: str | torch.device | None = None, ep_group=None):
    """Instantiate a model by registry name with dataset-derived dims.

    Initial weights come from `generator`, dropout masks from a generator
    seeded with `dropout_seed`. String booleans ("True"/"False") are
    coerced, as in the reference's YAML. `precision` is "f32" or "bf16"
    (bf16 activations over f32 masters, models/base.py); another value
    raises. `remat` recomputes each conv block in the backward
    (models/base.py). SM and SOAP take their input width from the
    dataset's descriptors. ep_group (MEGNet's only, a process group of ep
    members) is the mesh's, not a config field (models/megnet.py).
    """
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model '{name}'; have {sorted(MODEL_REGISTRY)}")
    kwargs = {}
    for k, v in (hyperparams or {}).items():
        if k not in MODEL_FIELDS[name]:
            continue
        if k in ("batch_norm", "batch_track_stats", "remat") and isinstance(v, str):
            v = v == "True"
        if k == "precision":
            v = check_precision(v)
        kwargs[k] = v
    kwargs.setdefault("output_dim", dataset.output_dim)
    if name in DESCRIPTOR_MODELS:
        return MODEL_REGISTRY[name](descriptor_width(dataset), **kwargs,
                                    generator=generator,
                                    dropout_seed=dropout_seed, device=device)
    kwargs.setdefault("num_features", dataset.num_features)
    kwargs.setdefault("edge_resolution", dataset.num_edge_features)
    kwargs.setdefault("edge_width", getattr(dataset, "edge_width", 0.2))
    if name == "MEGNet":
        kwargs["ep_group"] = ep_group
    return MODEL_REGISTRY[name](**kwargs, generator=generator,
                                dropout_seed=dropout_seed, device=device)
