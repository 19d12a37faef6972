"""Checkpoints: trees and plain objects as ``.npz`` + a JSON manifest, in
the JAX package's layout (``checkpoint/io.py``)."""
