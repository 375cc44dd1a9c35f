"""Checkpoints and quantized-model loading of the port."""
