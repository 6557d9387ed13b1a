"""matdeeplearn_torch — the PyTorch / CUDA port of the materials GNN framework.

A second package beside the reference TPU package, ported slice by slice
(see ROADMAP.md). Entry points run on CUDA unless the caller passes
device="cpu"; the CSR aggregation kernels are hand-written CUDA for Hopper
(csrc/csr.cu, bound in ops/csr.py) with plain PyTorch twins for CPU tensors.

Importing the package loads no submodule: import what you use, e.g.
`from matdeeplearn_torch.training.jobs import predict`.
"""

__version__ = "0.1.0"
