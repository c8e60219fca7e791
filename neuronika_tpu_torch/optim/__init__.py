"""Optimizers of the port (counterpart of `neuronika_tpu/optim/`)."""
