"""The language model: layers, attention and the dense transformer."""
