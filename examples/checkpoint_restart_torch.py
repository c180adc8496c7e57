"""Below-floor lifecycle of the PyTorch port (paper §3.4),
``examples/checkpoint_restart.py`` on the card: when failures push the
cluster under (f+1)*n0 nodes, Oobleck checkpoints, exits, and a later
run restores the training state (step, params, optimizer moments, data
cursor) once nodes are back.

    PYTHONPATH=src python examples/checkpoint_restart_torch.py            # H100
    PYTHONPATH=src python examples/checkpoint_restart_torch.py --device cpu

The checkpoint is on the JAX package's format: ``repro.ckpt`` restores
it as well.
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_arch, reduced
from repro_torch.core import (EngineConfig, InsufficientReplicasError,
                              OobleckEngine, build_profile)
from repro_torch.data import ByteCorpus, GlobalBatchDispenser
from repro_torch.launch.train import _TEXT, microbatches
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import HeteroTrainer
from repro_torch.utils.device import resolve_device, strict_fp32_numerics


def main(device="cuda", ckpt_dir=None) -> dict:
    """Both runs; returns their losses, the restored step and data
    cursor, and whether re-saving the restored state wrote nothing new
    (every shard content-equal to the checkpoint's)."""
    device = resolve_device(device)
    if device.type == "cuda":
        strict_fp32_numerics()
    arch = reduced(get_arch("gpt3_medium"), layers=3)
    profile = build_profile(arch, microbatch=2, seq_len=32)
    attn = "kernel" if device.type == "cuda" else "naive"
    model = Model(arch, dtype=torch.float32, attn_impl=attn)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, weight_decay=0.0)
    disp = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=32))
    own_dir = ckpt_dir is None
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="oobleck_ckpt_")
    mgr = CheckpointManager(ckpt_dir, num_layers=arch.num_layers,
                            async_mode=False)
    try:
        nodes = [f"n{i}" for i in range(4)]
        engine = OobleckEngine(profile, nodes, EngineConfig(
            fault_tolerance=1, global_batch=16, microbatch=2,
            gpus_per_node=1, n0_override=2))
        trainer = HeteroTrainer(model, engine, params, opt_cfg)
        run1, run2 = [], []
        for step in range(2):
            batches = disp.next_step(engine.batch.minibatch_sizes())
            out = trainer.train_step([microbatches(b, 2) for b in batches])
            run1.append(float(out["loss"]))
            print(f"[run1 step {step}] loss={run1[-1]:.4f}")

        # two failures push the cluster below (f+1)*n0=4 -> checkpoint + exit
        try:
            trainer.handle_failure({nodes[0]})
            trainer.handle_failure({nodes[1]})
        except InsufficientReplicasError as e:
            print(f"[run1] below floor: {e}")
            # snapshot() reassembles params AND the Adam moments from the
            # surviving replicas' layer states
            mgr.save(trainer.snapshot(disp.state(), 0))
            print(f"[run1] checkpointed step 2 to {ckpt_dir}")
        del trainer

        # --- later: nodes are back; restore and continue ----------------
        template = model.init(torch.Generator(device=device).manual_seed(0))
        template["head"] = template["embed"]                 # untied
        restored = mgr.restore(template, adamw.init(template), device=device)
        print(f"[run2] restored step={restored.step} "
              f"data_cursor={restored.data_state}")
        engine2 = OobleckEngine(profile, [f"m{i}" for i in range(5)],
                                EngineConfig(fault_tolerance=1,
                                             global_batch=16, microbatch=2,
                                             gpus_per_node=1, n0_override=2))
        trainer2 = HeteroTrainer(model, engine2, restored.params, opt_cfg,
                                 opt_state=restored.opt_state)
        # the restored state under a 5-node template set is the saved
        # one: saving it again skips every shard
        skipped = mgr.stats["skipped_shards"]
        mgr.save(trainer2.snapshot(restored.data_state, 0))
        exact = mgr.stats["skipped_shards"] - skipped == arch.num_layers + 1
        disp2 = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=32))
        disp2.restore(restored.data_state)
        for step in range(restored.step, restored.step + 2):
            batches = disp2.next_step(engine2.batch.minibatch_sizes())
            out = trainer2.train_step([microbatches(b, 2) for b in batches])
            run2.append(float(out["loss"]))
            print(f"[run2 step {step}] loss={run2[-1]:.4f}")
        print("done — resumed exactly where run 1 stopped."
              if exact else "restored state differs from the checkpoint")
    finally:
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"run1": run1, "run2": run2, "restored_step": restored.step,
            "data_state": restored.data_state, "exact": exact}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(ap.parse_args().device)
