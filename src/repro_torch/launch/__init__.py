"""Launch drivers of the port: ``serve`` (batched prefill + decode of a
model, then its energy-aware placement on the CFN)."""
