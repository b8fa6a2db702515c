"""Datasets and snapshot stores: the counterpart of the JAX package's
``data/``."""
