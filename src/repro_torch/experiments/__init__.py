"""The paper's experiments in the port (the counterparts of the JAX
package's ``benchmarks/table1_*.py`` and ``fig*.py``): ``python -m
repro_torch.experiments.<name>``, on the card unless ``--device cpu`` is
given.  Each prints JAX's ``name,us_per_call,derived`` lines."""
