"""Part of the PyTorch / CUDA port; see the package docstring."""
from repro_torch.optim.optimizers import (Optimizer, adam, sgd, momentum_sgd,
                                          apply_updates)
from repro_torch.optim.schedules import (constant, cosine, wsd,
                                         make_schedule)
