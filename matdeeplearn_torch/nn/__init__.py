"""nn subpackage of the PyTorch port."""
