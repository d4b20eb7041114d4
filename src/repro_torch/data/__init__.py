"""Synthetic multi-agent workloads."""
