"""The JAX package's examples in the port: ``python -m
repro_torch.examples.<quickstart|train_lm_symog|serve_quantized>``, on the
card unless ``--device cpu`` is given."""
