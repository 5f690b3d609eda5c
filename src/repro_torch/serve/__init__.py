"""Serving of the port: KV-cache specs, the prefill / decode engine, and
the energy-aware scheduler that places served models on the CFN."""
