"""Registry, WAV I/O and weight conversion for the port."""
