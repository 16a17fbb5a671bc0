"""PyTorch/CUDA port of the Lookahead serving stack (``repro``) for one
NVIDIA H100.

The package mirrors ``repro``'s layout module for module and imports
nothing from it: the host-side logic (trie, draft trees, verify, request
state, scheduler) is carried as its own copy, the model and serving step
functions are PyTorch, and the Pallas kernels on the serving path are CUDA
C++ kernels for ``sm_90a`` (``repro_torch.kernels``).
"""
