"""ONE-PEACE in PyTorch for NVIDIA Hopper: the port of ``one_peace_tpu``.

The layout mirrors the JAX package, so each module has a counterpart of the
same name there:

- ``models``  rel-pos tables, components, the fusion encoder, the text /
              image / audio adapters and the retrieval model
- ``ops``     bias-aware attention, the int8 serving path, preprocessing,
              and the wrappers of the hand-written CUDA kernels
- ``hub``     ``from_pretrained`` and the embedding interface; ``cli.embed``
- ``utils``   weights carried across from the JAX package and from fairseq
              ``.pt`` checkpoints
- ``csrc``    CUDA C++ kernel sources, built with ``nvcc`` at first use

The package imports ``torch`` and never ``jax``.  Of the JAX package it
imports only JAX-free host code: ``core.config``, ``utils.interpolate``, the
tokenizer and FLAC decoder under ``data``, and the numpy rules of
``utils.checkpoint_convert``.
"""
