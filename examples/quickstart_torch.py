"""Quickstart of the PyTorch port: plan pipeline templates, train through
a failure, recover — ``examples/quickstart.py``'s lifecycle, line for
line, on the card.

    PYTHONPATH=src python examples/quickstart_torch.py               # H100
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Walks the full Oobleck lifecycle on a 5-node simulated cluster:
  1. memory-driven node spec + pipeline templates (paper §4.1),
  2. max-throughput instantiation + batch distribution (§4.2),
  3. real heterogeneous 1F1B training with layer-granular sync (§6),
     every block through the fused QKV GEMM, the fused residual-add +
     RMSNorm and the flash-attention kernels (their plain versions on
     the CPU),
  4. a node failure -> recovery from replica state, no checkpoint (§5).
"""
import argparse

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import EngineConfig, OobleckEngine, build_profile
from repro_torch.data import ByteCorpus, GlobalBatchDispenser
from repro_torch.kernels import build
from repro_torch.launch.train import _TEXT, microbatches
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import HeteroTrainer
from repro_torch.utils.device import resolve_device, strict_fp32_numerics


def main(device="cuda", params=None) -> dict:
    """The lifecycle; returns the per-step losses, the replica divergence
    after each step and the kernel launches.  ``params`` (a parameter
    tree on ``device``) replaces the seeded initialisation."""
    device = resolve_device(device)
    if device.type == "cuda":
        strict_fp32_numerics()
    arch = reduced(get_arch("gpt3_medium"), layers=4)
    profile = build_profile(arch, microbatch=2, seq_len=32)
    nodes = [f"node{i}" for i in range(5)]
    engine = OobleckEngine(profile, nodes, EngineConfig(
        fault_tolerance=1, global_batch=16, microbatch=2,
        gpus_per_node=1, n0_override=2))

    print("== planning ==")
    for n, tpl in engine.templates.items():
        print(f"  template n={n}: {tpl.num_stages} stages, "
              f"layers per stage {[s.num_layers for s in tpl.stages]}, "
              f"est iter {tpl.iteration_time * 1e3:.1f}ms")
    print(f"  instantiated: {[i.template.num_nodes for i in engine.instances]}"
          f" pipelines; microbatches {engine.batch.num_microbatches}")

    print("== training ==")
    model = Model(arch, dtype=torch.float32, attn_impl="kernel")
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0))
    trainer = HeteroTrainer(model, engine, params,
                            adamw.AdamWConfig(lr=3e-3, warmup_steps=0,
                                              weight_decay=0.0))
    disp = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=32))
    build.reset_launches()
    losses, divergences = [], []

    def step(n):
        batches = disp.next_step(engine.batch.minibatch_sizes())
        out = trainer.train_step([microbatches(b, 2) for b in batches])
        losses.append(float(out["loss"]))
        divergences.append(trainer.replica_divergence())
        return losses[-1]

    for n in range(3):
        print(f"  step {n}: loss {step(n):.4f}")

    print("== failure ==")
    victim = engine.instances[0].nodes[-1]
    info = trainer.handle_failure({victim})
    print(f"  killed {victim}; copied {info['copied_bytes'] / 1e6:.1f}MB "
          f"of layer state from replicas; pipelines now "
          f"{[i.template.num_nodes for i in engine.instances]}")

    for n in range(3, 5):
        print(f"  step {n}: loss {step(n):.4f} "
              f"(replica divergence {divergences[-1]:.1e})")
    launches = dict(build.LAUNCHES)
    if device.type == "cuda":
        print(f"  kernel launches: {launches}")
    print("done — training continued through the failure without restart.")
    return {"losses": losses, "divergences": divergences,
            "launches": launches}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(ap.parse_args().device)
