"""Models of the port: GPT-2 in decode mode, its weights and generation."""
