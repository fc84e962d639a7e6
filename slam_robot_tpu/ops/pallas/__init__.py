"""Hand-written Pallas kernels for the GPU (through Triton).

Each kernel sits beside a plain-jnp reference with the same semantics;
the CPU tests run the kernel in interpret mode against that reference, and
the card-only tests (``pytest -m gpu``) compare the compiled kernel.
"""
