"""Checkpoints of the port in the JAX package's store layout (`store`):
the reader, which is how JAX-trained weights reach the port, and the
writer of the GAN trainer's and the LLM trainer's states."""
