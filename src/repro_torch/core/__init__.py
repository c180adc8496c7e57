# The paper's primary contribution: pipeline-template planning and the
# resilient execution engine (Oobleck, SOSP 2023).
from repro_torch.core.adapt import (AdaptationError, AdaptCostModel, AdaptCostRow,
                              AdaptPlan)
from repro_torch.core.batch import BatchPlan, distribute_batch, distribute_microbatches
from repro_torch.core.cost_model import LayerCost, ModelProfile, build_profile
from repro_torch.core.engine import ConfigurationEngine, EngineConfig, OobleckEngine
from repro_torch.core.instantiator import (InstantiationPlan, choose_plan,
                                     enumerate_feasible_sets)
from repro_torch.core.monitor import (ClusterEvent, HeartbeatConfig,
                                HeartbeatTracker, NodeChangeMonitor)
from repro_torch.core.planner import PipelinePlanner, estimate_iteration_time
from repro_torch.core.reconfigure import (CopyTask, InsufficientReplicasError,
                                    PipelineInstance, ReconfigResult,
                                    Reconfigurator)
from repro_torch.core.sync import (LayerGroup, SyncBucket, build_sync_plan,
                             layer_groups, verify_replica_coverage)
from repro_torch.core.templates import (NodeSpec, PipelineTemplate, PlanningError,
                                  StageSpec, coverable, generate_node_spec)

__all__ = [
    "AdaptationError", "AdaptCostModel", "AdaptCostRow", "AdaptPlan",
    "BatchPlan", "distribute_batch", "distribute_microbatches",
    "LayerCost", "ModelProfile", "build_profile",
    "ConfigurationEngine", "EngineConfig", "OobleckEngine",
    "InstantiationPlan", "choose_plan", "enumerate_feasible_sets",
    "ClusterEvent", "HeartbeatConfig", "HeartbeatTracker",
    "NodeChangeMonitor",
    "PipelinePlanner", "estimate_iteration_time",
    "CopyTask", "InsufficientReplicasError", "PipelineInstance",
    "ReconfigResult", "Reconfigurator",
    "LayerGroup", "SyncBucket", "build_sync_plan", "layer_groups",
    "verify_replica_coverage",
    "NodeSpec", "PipelineTemplate", "PlanningError", "StageSpec",
    "coverable", "generate_node_spec",
]
