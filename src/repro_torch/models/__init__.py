# Subpackages imported lazily, as in the JAX package.
