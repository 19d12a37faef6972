"""PyTorch / CUDA port of the FedDF system for NVIDIA Hopper (H100).

Mirrors the layout of the JAX package ``repro`` (the reference, which it
never imports) and runs its main path, the paper's Algorithm 1 as
``examples/quickstart.py`` runs it, on the card: ``repro_torch.api.
Experiment(spec).run()``.  Its kernels are CUDA C++ under
``kernels/csrc/``, built with nvcc at first use.
"""
