"""Launch drivers of the port: ``serve`` (batched prefill + decode of a
model, then its energy-aware placement on the CFN), ``train`` (training,
resumable through checkpoints, then the trained architecture's
placement), ``mesh`` (``DeviceMesh`` construction, the card's roofline
constants) and ``specs`` (abstract inputs and states on ``meta``)."""
