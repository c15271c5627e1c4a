"""PyTorch/CUDA port of the repartitioned CFD solver (see ``src/repro``).

The package mirrors the JAX package's layout module for module and imports
neither JAX nor anything of ``repro``: it keeps its own copies of the
numpy-only modules it needs.  Entry points take an explicit ``device``
(default ``"cuda"``); the solver path runs in float64.
"""
