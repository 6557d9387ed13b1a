"""Data and edge parallelism over torch.distributed (the reference
package's parallel/): the process mesh (mesh.py), the halo exchange
(ring.py) and the dp/ep steps (spmd.py)."""
