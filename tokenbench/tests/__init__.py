"""CPU tests of the benchmark harness (run: python -m pytest tokenbench/tests)."""
