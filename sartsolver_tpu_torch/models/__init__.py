"""The SART solver and the conversion of problems from the JAX package."""
