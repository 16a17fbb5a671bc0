"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package per
Pallas kernel of ``repro.kernels`` that the serving path runs.  Each
package holds the CUDA source (``csrc/``), the wrapper (``ops.py``) and
the plain PyTorch version (``ref.py``); ``_build.py`` compiles the sources
with ``nvcc`` at first use."""
