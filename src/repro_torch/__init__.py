"""ForkGraph in PyTorch and CUDA: the port of the JAX package ``repro``.

The package mirrors ``repro``'s layout (``core/``, ``fpp/``, ``graphs/``,
``kernels/``) and imports nothing of it, nor of JAX.  Entry points run on
the CUDA device unless they are given ``device="cpu"``.
"""
