"""Checkpoints of the port: reading the JAX package's store layout
(`store`), which is how trained weights reach the port."""
