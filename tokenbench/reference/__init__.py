"""The plain PyTorch reference and the comparison that decides correct."""
