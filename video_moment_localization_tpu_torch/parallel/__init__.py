"""Parallelism of the PyTorch port (see the package docstring): data
parallelism over ``torch.distributed`` (`mesh`), the train and eval steps
(`steps`), and sequence and 2-D (data x seq) parallelism (`sequence`,
`model_parallel`, over the differentiable collectives of `collectives`).

The entry points below are exported lazily: importing this package loads
none of its submodules, so ``parallel.mesh`` does not pull in the model."""

import importlib

_EXPORTS = {
    "mesh": ("Grid2D", "all_reduce_gradients", "all_reduce_sums", "initialize_distributed",
             "make_grid_2d", "put_batch", "put_replicated", "spawn"),
    "steps": ("make_train_step", "make_eval_step"),
    "sequence": ("proposal_features_seq_sharded",),
    "model_parallel": ("smin_forward_seq_sharded", "smin_forward_seq_sharded_packed",
                       "make_train_step_2d", "make_eval_step_2d", "put_batch_2d"),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = list(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_MODULE_OF[name]}")
    return getattr(module, name)
