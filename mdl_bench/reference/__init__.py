"""The benchmark's plain reference: the corpus and its graphs in numpy, and
CGCNN and MPNN (forward, L1 loss, backward, AdamW) in plain PyTorch at
float32 with TF32 off. It imports nothing of the program: the harness hands
it the same inputs (the corpus, the weights, the graph ids of each batch)
and reads the program's outputs only to judge them. `reference.<model>`
holds one architecture, found by the lower-cased `model` of a
configuration."""
