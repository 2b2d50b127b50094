from .convert import init_weights, state_dict_from_jax_params

__all__ = ["init_weights", "state_dict_from_jax_params"]
