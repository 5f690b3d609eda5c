"""Model stack of the port, dense-attention subset: the architecture
config, transformer layers (attention through the flash-attention kernel
on the card), model assembly and cost accounting."""
