from .jax_params import from_jax, load_jax_params, to_jax  # noqa: F401
