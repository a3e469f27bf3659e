"""ONE-PEACE in PyTorch for NVIDIA Hopper: the port of ``one_peace_tpu``.

The layout mirrors the JAX package, so each module has a counterpart of the
same name there:

- ``core``    the configuration dataclasses and ``load_config``, the task and
              model registries, the training meters and logging sinks
- ``data``    the BPE tokenizer, the FLAC reader, TSV tables, collation, the
              epoch batch iterator and the retrieval datasets
- ``models``  rel-pos tables, components, the fusion encoder, the text /
              image / audio adapters and the retrieval model
- ``vision``  the detection trunk, its pyramid, proposers, RoIAlign, the
              cascade box and mask heads, and ``OnePeaceDetector``
- ``ops``     bias-aware attention, the detection trunk's attention, the
              int8 serving path, preprocessing, and the wrappers of the
              hand-written CUDA kernels
- ``tasks``   the retrieval tasks (datasets, batches, evaluation) and the
              detection task; ``metrics``: ``Recall``
- ``hub``     ``from_pretrained`` and the embedding interface; ``cli.embed``,
              ``cli.train`` (fine-tuning from data) and ``cli.evaluate``
- ``utils``   weights carried across from the JAX package and from fairseq
              ``.pt`` checkpoints, parameter exports and train-state bundles
- ``csrc``    CUDA C++ kernel sources, built with ``nvcc`` at first use

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: where it needs that package's JAX-free host code (the config, the
tokenizer, the FLAC reader, the interpolation matrices, the checkpoint
rules, the data pipeline and the meters), it keeps its own copy, held equal
to the original by ``tests/test_torch_port_copies.py`` and
``tests/test_torch_port_retrieval_data.py``.
"""
