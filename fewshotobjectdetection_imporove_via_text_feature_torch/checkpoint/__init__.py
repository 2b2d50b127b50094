from .checkpointer import (
    Checkpointer,
    load_checkpoint_file,
    load_jax_checkpoint,
    read_weights,
)
from .convert import init_weights, state_dict_from_jax_params
from .surgery import reset_optimizer, surgery_randinit, surgery_remove

__all__ = [
    "Checkpointer",
    "load_checkpoint_file",
    "load_jax_checkpoint",
    "read_weights",
    "init_weights",
    "state_dict_from_jax_params",
    "reset_optimizer",
    "surgery_randinit",
    "surgery_remove",
]
