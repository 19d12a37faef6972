"""Component registries for the declarative experiment API.

Every axis a spec references by name resolves through one of these
tables, as in the JAX package:

task(name)       ``fn(n_samples, seed, **params) -> TaskBundle``
model(name)      ``fn(task: TaskBundle, **params) -> Net``
source(name)     ``fn(task, train, seed, device, **params) -> DistillSource``
quantizer(name)  ``fn(params, stacked=False) -> params``

Every name the JAX package registers is registered here too: tasks
``blobs`` and ``tokens``, models ``mlp`` and ``tiny_transformer`` (and
both task families' prototype ladders, :func:`default_prototype_ladder`),
sources ``unlabeled``, ``in_domain``, ``generator`` and ``noise`` (token
outputs for a token task), and quantizer ``binarize``
(``core/quantize.py``).  Unknown names raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.nets import Net, mlp, tiny_transformer
from repro_torch.core.quantize import binarize
from repro_torch.data.distill_sources import (DistillSource,
                                              GeneratorSource,
                                              RandomNoiseSource,
                                              UnlabeledDataset)
from repro_torch.data.synthetic import (Dataset, gaussian_mixture,
                                        token_sequences)


@dataclasses.dataclass
class TaskBundle:
    """The full dataset, the shape of the distillation inputs, the token
    vocabulary (None for dense inputs) and the model-builder kwargs."""

    dataset: Dataset
    distill_shape: tuple
    vocab: Optional[int]
    model_kwargs: Dict[str, Any]


def _make_registry(kind: str):
    table: Dict[str, Callable] = {}

    def register(name: str):
        def deco(fn):
            table[name] = fn
            return fn
        return deco

    def get(name: str) -> Callable:
        if name not in table:
            raise ValueError(f"unknown {kind} {name!r}; registered: "
                             f"{sorted(table)}")
        return table[name]

    def available() -> List[str]:
        return sorted(table)

    return register, get, available


register_task, get_task, available_tasks = _make_registry("task")
register_model, get_model, available_models = _make_registry("model")
register_source, get_source, available_sources = _make_registry("source")
register_quantizer, get_quantizer, available_quantizers = _make_registry(
    "quantizer")
register_quantizer("binarize")(binarize)


@register_task("blobs")
def _blobs_task(n_samples: int = 6000, seed: int = 0, n_classes: int = 3,
                dim: int = 2, spread: float = 2.2,
                noise: float = 1.0) -> TaskBundle:
    """M-class Gaussian mixture in R^d (the paper's Fig. 1 toy)."""
    ds = gaussian_mixture(n_samples, n_classes=n_classes, dim=dim,
                          spread=spread, noise=noise, seed=seed)
    return TaskBundle(ds, (dim,), None,
                      {"in_dim": dim, "n_classes": n_classes})


@register_task("tokens")
def _tokens_task(n_samples: int = 6000, seed: int = 0, n_classes: int = 4,
                 vocab: int = 64, seq_len: int = 16,
                 marker_rate: float = 0.3) -> TaskBundle:
    """Synthetic token classification (the AG News stand-in)."""
    ds = token_sequences(n_samples, n_classes=n_classes, vocab=vocab,
                         seq_len=seq_len, marker_rate=marker_rate, seed=seed)
    return TaskBundle(ds, (seq_len,), vocab,
                      {"vocab": vocab, "n_classes": n_classes,
                       "seq_len": seq_len})


@register_model("mlp")
def _mlp_model(task: TaskBundle, hidden=(64, 64, 64), norm: str = "none",
               groups: int = 8, name: Optional[str] = None) -> Net:
    kw = task.model_kwargs
    if "in_dim" not in kw:
        raise ValueError("model 'mlp' needs a dense-input task (got task "
                         f"kwargs {sorted(kw)})")
    return mlp(kw["in_dim"], kw["n_classes"], hidden=tuple(hidden),
               norm=norm, groups=groups, name=name)


@register_model("tiny_transformer")
def _tiny_transformer_model(task: TaskBundle, d_model: int = 64,
                            n_layers: int = 2, n_heads: int = 4,
                            name: Optional[str] = None) -> Net:
    kw = task.model_kwargs
    if "vocab" not in kw:
        raise ValueError("model 'tiny_transformer' needs a token task (got "
                         f"task kwargs {sorted(kw)})")
    return tiny_transformer(kw["vocab"], kw["n_classes"], kw["seq_len"],
                            d_model=d_model, n_layers=n_layers,
                            n_heads=n_heads, name=name)


def default_prototype_ladder(task_name: str) -> List[dict]:
    """The small/medium/large heterogeneous prototype ladder (paper Fig.
    4's ResNet-20/32/ShuffleNetV2 analogue) as ModelSpec dicts, per task
    family, as the JAX package defines it."""
    if task_name == "blobs":
        return [
            {"name": "mlp", "params": {"hidden": [48, 48],
                                       "name": "proto-s"}},
            {"name": "mlp", "params": {"hidden": [64, 64, 64],
                                       "name": "proto-m"}},
            {"name": "mlp", "params": {"hidden": [96, 96],
                                       "name": "proto-l"}},
        ]
    if task_name == "tokens":
        return [
            {"name": "tiny_transformer", "params": {"d_model": 48,
                                                    "n_layers": 1}},
            {"name": "tiny_transformer", "params": {"d_model": 64,
                                                    "n_layers": 2}},
            {"name": "tiny_transformer", "params": {"d_model": 96,
                                                    "n_layers": 2}},
        ]
    raise ValueError(f"no default prototype ladder for task {task_name!r}")


@register_source("unlabeled")
def _unlabeled_source(task: TaskBundle, train: Dataset, seed: int = 0,
                      device="cpu", n: int = 4000, low: float = -3.0,
                      high: float = 3.0) -> DistillSource:
    """Out-of-domain unlabeled pool, held on ``device``: a uniform square
    for dense tasks (a different manifold from the task's blobs), token
    sequences from another seed for a token task."""
    if task.vocab is None:
        x = np.random.default_rng(seed + 7).uniform(
            low, high, (n,) + tuple(task.distill_shape)).astype(np.float32)
    else:
        x = token_sequences(n, n_classes=task.model_kwargs["n_classes"],
                            vocab=task.vocab, seq_len=task.distill_shape[0],
                            seed=seed + 7).x
    return UnlabeledDataset(x, device=device)


@register_source("in_domain")
def _in_domain_source(task: TaskBundle, train: Dataset, seed: int = 0,
                      device="cpu") -> DistillSource:
    """The training inputs themselves, labels discarded (Fig. 5's
    best-case control)."""
    return UnlabeledDataset(train.x, device=device)


@register_source("generator")
def _generator_source(task: TaskBundle, train: Dataset, seed: int = 0,
                      device="cpu", mean: float = 0.0, std: float = 1.5,
                      latent_dim: int = 16,
                      hidden: int = 64) -> DistillSource:
    return GeneratorSource(tuple(task.distill_shape),
                           discrete_vocab=task.vocab, mean=mean, std=std,
                           latent_dim=latent_dim, hidden=hidden, seed=seed,
                           device=device)


@register_source("noise")
def _noise_source(task: TaskBundle, train: Dataset, seed: int = 0,
                  device="cpu", low: float = -3.0,
                  high: float = 3.0) -> DistillSource:
    return RandomNoiseSource(tuple(task.distill_shape), low=low, high=high,
                             discrete_vocab=task.vocab, device=device)
