"""SM and SOAP: MLP heads over whole-structure descriptors (reference:
matdeeplearn/models/descriptor_nn.py; the reference package's
models/descriptor_nn.py).

ReLU(lin1) → fc_count × ReLU(lin_list{i}) → lin2 → squeeze to (B,) when
output_dim is 1, over batch.extra, the (B, D) descriptor rows
(data/batching.py). The input width D is the dataset's descriptor width
(in_dim). Dense products only: no edge aggregation, so no hand kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from matdeeplearn_torch.nn.layers import Linear


class _DescriptorNN(nn.Module):
    def __init__(self, in_dim: int, dim1: int = 64, fc_count: int = 1,
                 output_dim: int = 1, *,
                 generator: torch.Generator | None = None,
                 dropout_seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__()
        del dropout_seed  # no dropout in these models
        kw = dict(generator=generator, device=device)
        self.fc_count = fc_count
        self.lin1 = Linear(in_dim, dim1, **kw)
        for i in range(fc_count):
            self.add_module(f"lin_list{i}", Linear(dim1, dim1, **kw))
        self.lin2 = Linear(dim1, output_dim, **kw)

    def forward(self, batch):
        if batch.extra is None:
            raise ValueError(
                "descriptor models need extra features; enable "
                "SOAP_descriptor/SM_descriptor in Processing config")
        out = F.relu(self.lin1(batch.extra))
        for i in range(self.fc_count):
            out = F.relu(getattr(self, f"lin_list{i}")(out))
        out = self.lin2(out)
        if out.shape[-1] == 1:
            return out.reshape(-1)
        return out


class SM(_DescriptorNN):
    pass


class SOAP(_DescriptorNN):
    pass
