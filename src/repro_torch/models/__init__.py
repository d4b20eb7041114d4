"""Dense decoder on the paged KV pool."""
