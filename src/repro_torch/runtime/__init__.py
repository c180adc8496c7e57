"""The port's runtime: executor interface and program cache, the
heterogeneous pipeline trainer, the bucketed sync plane, the
multi-process backend (coordination channel, coordinator and shard
trainers), the sharding specs and the single-program fast path
(``spmd``, ``SPMDExecutor``), and copies of the framework-free schedule
and transfer planners."""
from repro_torch.runtime.coordination import (CoordinatorServer, DataServer,
                                              EpochMismatch, WorkerChannel,
                                              WorkerLost, data_call,
                                              pack_batches, pack_tree,
                                              recv_msg, send_msg,
                                              unpack_batches, unpack_tree)
from repro_torch.runtime.executor import (CompileCounter, Executor,
                                          ExecutorUnsupported, ProgramCache,
                                          template_signature, track_compiles,
                                          track_host_transfers, tree_spec)
from repro_torch.runtime.pipeline import HeteroTrainer, split_into_layers
from repro_torch.runtime.multihost import (MultiHostExecutor, ShardTrainer,
                                           build_setup, layer_state_hash,
                                           make_job_spec)
from repro_torch.runtime import spmd
from repro_torch.runtime.sharding import ShardingStrategy
from repro_torch.runtime.spmd import SPMDExecutor, SPMDServer
from repro_torch.runtime.sync_exec import (BucketedSync, BucketExec,
                                           perlayer_global_sumsq,
                                           perlayer_sync)
from repro_torch.runtime.transfer import (Topology, TransferPlan,
                                          TransferPlanError, TransferStream,
                                          schedule_transfers)

__all__ = ["CoordinatorServer", "DataServer", "EpochMismatch",
           "WorkerChannel", "WorkerLost", "data_call", "pack_batches",
           "pack_tree", "recv_msg", "send_msg", "unpack_batches",
           "unpack_tree",
           "CompileCounter", "Executor", "ExecutorUnsupported",
           "ProgramCache", "template_signature", "track_compiles",
           "track_host_transfers", "tree_spec",
           "HeteroTrainer", "split_into_layers",
           "MultiHostExecutor", "ShardTrainer", "build_setup",
           "layer_state_hash", "make_job_spec",
           "ShardingStrategy", "SPMDExecutor", "SPMDServer", "spmd",
           "BucketedSync", "BucketExec", "perlayer_global_sumsq",
           "perlayer_sync",
           "Topology", "TransferPlan", "TransferPlanError",
           "TransferStream", "schedule_transfers"]
