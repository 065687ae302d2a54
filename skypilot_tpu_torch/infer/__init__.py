"""Serving data plane of the port: pooled KV arena, batcher, replica."""
