"""Serving-side formats of the port (the KV handoff image codec)."""
