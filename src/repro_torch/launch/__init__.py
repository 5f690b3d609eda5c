"""Launch drivers of the port: ``serve`` (batched prefill + decode of a
model, then its energy-aware placement on the CFN) and ``train`` (training
on one device, then the trained architecture's placement)."""
