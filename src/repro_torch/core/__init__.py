"""Engine, schedulers and cost model (copied from repro.core) plus the PyTorch backend."""
