"""tailored_avsr_tpu_torch — the PyTorch/CUDA port of ``tailored_avsr_tpu``.

The JAX package stays the reference; every module here mirrors the JAX
module of the same path and is held against it on the CPU
(``tests/test_torch_port_*.py``). The first slice covers the flagship
tailored AVSR encoder and greedy CTC serving:

- ``ops/``     : frontends, MVN, subsampling, positional encodings, rel-pos
                 attention, cgMLP, FFN, plus the wrappers of the hand-written
                 CUDA kernels (``flash_attention.py``, ``fused_csgu.py``);
- ``models/``  : Conv3D + ResNet-18 visual frontend, AVSR embeddings, the
                 tailored encoder, adaptive fusion, CTC head, the AVSR model;
- ``tasks/``   : config -> model for the flagship combination;
- ``decode/``  : greedy CTC collapse;
- ``inference``: ``Speech2Text`` with the greedy decode mode;
- ``utils/``   : JAX parameters -> port state dict, seeded initialisation;
- ``csrc/``    : CUDA C++ sources for ``sm_90a``;
- ``kernels/`` : nvcc build and ctypes bindings.

Conventions follow the JAX package: arrays are ``(B, T, D)``, masks are bool
``(B, T)`` with True = valid frame. Kernels are forward-only: a wrapper runs
its plain PyTorch version for a CPU tensor and launches the CUDA kernel (or
raises) for a CUDA tensor. Nothing here imports JAX.
"""

__version__ = "0.1.0"
