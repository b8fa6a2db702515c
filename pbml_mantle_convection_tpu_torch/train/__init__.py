"""Losses, train and eval steps, the epoch loop and the Trainer: the
counterpart of the JAX package's ``train/``."""
