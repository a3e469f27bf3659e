"""ONE-PEACE in PyTorch for NVIDIA Hopper: the port of ``one_peace_tpu``.

The layout mirrors the JAX package, so each module has a counterpart of the
same name there:

- ``models``  rel-pos tables, components, the fusion encoder, the text /
              image / audio adapters and the retrieval model
- ``ops``     bias-aware attention and its hand-written CUDA kernel
- ``utils``   weights carried across from the JAX package
- ``csrc``    CUDA C++ kernel sources, built with ``nvcc`` at first use

The package imports ``torch`` and never ``jax``.  Of the JAX package it
imports only the JAX-free ``core.config`` and ``utils.interpolate``.
"""
