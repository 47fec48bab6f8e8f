"""The language model: layers, attention, the transformer (dense and SSM
families), the mamba2 mixer and single-token decode."""
