"""Train and eval steps of the PyTorch port (see the package docstring)."""
