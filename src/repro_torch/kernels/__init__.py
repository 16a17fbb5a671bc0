"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package per
Pallas kernel of ``repro.kernels`` (the serving path's and the recsys
scoring path's), plus the Gumbel-argmax token choice.  Each package holds
the CUDA source (``csrc/``), the wrapper (``ops.py``) and the plain PyTorch
version (``ref.py``); ``_build.py`` compiles the sources with ``nvcc`` at
first use."""
