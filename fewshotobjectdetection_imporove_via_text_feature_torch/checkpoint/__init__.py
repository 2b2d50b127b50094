from .checkpointer import (
    Checkpointer,
    full_model_state,
    load_checkpoint_file,
    load_jax_checkpoint,
    load_training_state,
    training_state,
)
from .convert import init_weights, state_dict_from_jax_params
from .torch_import import (
    load_reference_weights,
    load_torch_state,
    maybe_load_reference_weights,
)
from .surgery import (
    reset_optimizer,
    surgery_randinit,
    surgery_remove,
    surgery_reset_student,
)

__all__ = [
    "Checkpointer",
    "full_model_state",
    "load_training_state",
    "training_state",
    "load_checkpoint_file",
    "load_jax_checkpoint",
    "load_reference_weights",
    "load_torch_state",
    "maybe_load_reference_weights",
    "init_weights",
    "state_dict_from_jax_params",
    "reset_optimizer",
    "surgery_randinit",
    "surgery_remove",
    "surgery_reset_student",
]
