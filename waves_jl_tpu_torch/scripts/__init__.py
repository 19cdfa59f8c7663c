"""Command-line workflows of the port (counterparts of `scripts_tpu/`)."""
