"""The model zoo (the JAX package's ``models/``) in PyTorch: layers,
attention, the Mamba2 SSD block and the unified transformer."""
