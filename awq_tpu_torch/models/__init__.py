"""Subpackage of awq_tpu_torch; see the package docstring."""
