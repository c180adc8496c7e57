"""The port's runtime: executor interface and program cache, the
heterogeneous pipeline trainer, the bucketed sync plane, and copies of
the framework-free schedule and transfer planners."""
from repro_torch.runtime.executor import (CompileCounter, Executor,
                                          ExecutorUnsupported, ProgramCache,
                                          template_signature, track_compiles,
                                          track_host_transfers, tree_spec)
from repro_torch.runtime.pipeline import HeteroTrainer, split_into_layers
from repro_torch.runtime.sync_exec import (BucketedSync, BucketExec,
                                           perlayer_global_sumsq,
                                           perlayer_sync)
from repro_torch.runtime.transfer import (Topology, TransferPlan,
                                          TransferPlanError, TransferStream,
                                          schedule_transfers)

__all__ = ["CompileCounter", "Executor", "ExecutorUnsupported",
           "ProgramCache", "template_signature", "track_compiles",
           "track_host_transfers", "tree_spec",
           "HeteroTrainer", "split_into_layers",
           "BucketedSync", "BucketExec", "perlayer_global_sumsq",
           "perlayer_sync",
           "Topology", "TransferPlan", "TransferPlanError",
           "TransferStream", "schedule_transfers"]
