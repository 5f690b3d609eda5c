"""Model stack of the port: the architecture config, the layers (attention
through the flash-attention kernel on the card, differentiable through the
reference's chunked backward; MLA, top-k MoE), the recurrent blocks, model
assembly with the training forward and chunked loss, and cost
accounting."""
