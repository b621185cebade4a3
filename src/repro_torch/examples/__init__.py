"""The port's examples, counterparts of the repository's ``examples/``:
``quickstart``, ``serve_memforest``, ``migration_merge`` and ``train_lm``.
Each runs as ``python -m repro_torch.examples.<name>`` on the CUDA card by
default, or on the CPU with ``--device cpu``; importing one runs nothing."""
