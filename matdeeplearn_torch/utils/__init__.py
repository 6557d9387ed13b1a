"""utils subpackage of the PyTorch port."""
