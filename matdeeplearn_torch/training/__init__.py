"""training subpackage of the PyTorch port."""
