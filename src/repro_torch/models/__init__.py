# Subpackages imported lazily, as in the JAX package (recsys and gnn are
# ported in a later slice).
