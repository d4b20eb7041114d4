"""Tokencake on PyTorch and CUDA.

The serving path of the JAX package ``repro`` (engine, paged KV cache with
host offload, dense decoder) ported to PyTorch, with the TPU kernels of
that path rewritten as CUDA kernels for Hopper (``kernels/csrc``). The
framework-free control plane (``core`` scheduling, ``kvcache`` prefix
store, ``data/workloads``, ``configs``) is a verbatim copy of the JAX
package's, with ``repro.`` imports renamed; ``tests/test_torch_port_rules``
holds the copies to their originals.
"""
