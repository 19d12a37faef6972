"""Declarative experiment API of the port (the JAX package's spec JSON).

    from repro_torch.api import Experiment, ExperimentSpec
    result = Experiment(spec).run()            # on the card
"""
from repro_torch.api.experiment import (Experiment, RoundEvent, RunResult,
                                        build_cohort, build_engine,
                                        build_source, build_splits,
                                        build_task_bundle, resolve_device,
                                        to_fl_config)
from repro_torch.api.registries import (TaskBundle, available_models,
                                        available_quantizers,
                                        available_sources, available_tasks,
                                        default_prototype_ladder,
                                        get_model, get_quantizer, get_source,
                                        get_task, register_model,
                                        register_quantizer, register_source,
                                        register_task)
from repro_torch.api.spec import (BucketSpec, CohortSpec, DistSpec,
                                  DriverSpec, ExperimentSpec, FaultSpec,
                                  FusionSpec, ModelSpec, ObsSpec,
                                  PartitionSpec, PopulationSpec, PrivacySpec,
                                  ShardingSpec, SourceSpec, StrategySpec,
                                  TaskSpec, TrafficSpec)

__all__ = [
    "Experiment", "RoundEvent", "RunResult", "ExperimentSpec", "TaskSpec",
    "PartitionSpec", "CohortSpec", "ModelSpec", "SourceSpec",
    "StrategySpec", "FusionSpec", "PrivacySpec", "ShardingSpec",
    "DriverSpec", "BucketSpec", "PopulationSpec", "TrafficSpec",
    "FaultSpec", "ObsSpec", "DistSpec", "TaskBundle", "register_task",
    "register_model", "register_source", "register_quantizer", "get_task",
    "get_model", "get_source", "get_quantizer", "available_tasks",
    "available_models", "available_sources", "available_quantizers",
    "default_prototype_ladder", "build_task_bundle", "build_splits",
    "build_cohort", "build_source", "build_engine", "resolve_device",
    "to_fl_config",
]
