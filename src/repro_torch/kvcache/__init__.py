"""Paged KV cache and the prefix store."""
