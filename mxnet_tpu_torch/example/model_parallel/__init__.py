"""The port of the JAX package's ``example/model-parallel/``."""
