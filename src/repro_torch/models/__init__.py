"""The language model: layers, attention (GQA and MLA), mixture of
experts, the transformer (dense, MoE and SSM families), the mamba2 mixer
and single-token decode."""
