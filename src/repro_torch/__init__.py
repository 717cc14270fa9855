"""PyTorch + CUDA port of the ``repro`` AutoQ serving stack for one NVIDIA
H100.

It mirrors ``repro``'s subpackages (configs, models, quant, kernels,
serve) and imports neither JAX nor ``repro``.  Entry points run on the
card unless the caller passes ``device="cpu"`` (``backend.py``).  The
kernels the path runs are CUDA C++ under ``csrc/``, built at first use
(``kernels/build.py``).
"""
