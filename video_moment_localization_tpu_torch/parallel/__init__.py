"""Data parallelism (`mesh`) and the train and eval steps (`steps`) of the PyTorch port
(see the package docstring)."""
