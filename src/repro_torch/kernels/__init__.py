"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` is the entry point the models call; it routes by tensor device.
Sources live in ``csrc/`` and build at first use (``build.py``).
"""
