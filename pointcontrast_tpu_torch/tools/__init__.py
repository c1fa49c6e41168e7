"""Tools (port): the weight bridge from the JAX package."""
