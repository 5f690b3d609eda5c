"""Model stack of the port, dense attention and the MoE family: the
architecture config, transformer layers (attention through the
flash-attention kernel on the card, MLA, top-k MoE), model assembly and
cost accounting."""
