"""Serving of the port: KV-cache specs and the prefill / decode engine."""
