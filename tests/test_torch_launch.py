"""The port's entry points: the training CLI on the CPU (plan -> train ->
fail -> recover), the flags of later slices, the no-fallback rule (CUDA
requested without a card raises), and a CPU rehearsal of chip_smoke.py's
whole control flow with the plain versions standing in for the kernels."""
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.utils.device import resolve_device

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("attn_impl", ["naive", "kernel"])
@pytest.mark.parametrize("policy", ["replan", "adapt"])
def test_train_cli_on_cpu_recovers_without_builds(policy, attn_impl, capsys):
    out = train.main(["--steps", "4", "--kill-at", "2", "--layers", "2",
                      "--recovery-policy", policy, "--attn-impl", attn_impl,
                      "--device", "cpu"])
    text = capsys.readouterr().out
    for tag in ("[plan]", "[sync]", "[warm]", "[fail]", "[step 3]", "[done]"):
        assert tag in text, tag
    assert out["losses"][-1] < out["losses"][0]
    assert all(d == 0.0 for d in out["divergences"])
    assert out["recovery"]["policy"] == policy
    assert set(out["builds_after_step"]) == {out["recovery"]["builds_before"]}


def test_train_cli_on_cpu_trains_mamba2_through_the_ssd_kernels(capsys,
                                                                monkeypatch):
    """--arch mamba2-780m --ssd-impl kernel: the flag reaches the Model
    (the SSD kernels' plain versions on the CPU) and training recovers
    from the failure with no builds."""
    seen = []

    class Recording(Model):
        def __post_init__(self):
            seen.append(self.ssd_impl)
            super().__post_init__()
    monkeypatch.setattr(train, "Model", Recording)
    out = train.main(["--arch", "mamba2-780m", "--ssd-impl", "kernel",
                      "--steps", "4", "--kill-at", "2", "--layers", "2",
                      "--device", "cpu"])
    assert seen == ["kernel"]
    assert "[fail]" in capsys.readouterr().out
    assert out["losses"][-1] < out["losses"][0]
    assert all(d == 0.0 for d in out["divergences"])
    assert set(out["builds_after_step"]) == {out["recovery"]["builds_before"]}


def test_train_cli_procs_trains_through_a_sigkill(capsys):
    """--procs 3: the coordinator here, three spawned workers; the last
    rank is SIGKILLed before step 2, its death detected from the
    channel, and training continues with falling losses, no replica
    divergence and no build on the survivors since warm."""
    out = train.main(["--procs", "3", "--steps", "4", "--kill-at", "2",
                      "--device", "cpu"])
    text = capsys.readouterr().out
    for tag in ("[plan] procs=3", "[warm]", "[fail] SIGKILL rank 2",
                "[step 3]", "[done]"):
        assert tag in text, tag
    assert out["losses"][-1] < out["losses"][0]
    assert all(l1 < l0 for l0, l1 in zip(out["losses"], out["losses"][1:]))
    assert out["divergences"] == [0, 0, 0, 0]
    assert out["recovery"]["fetched_bytes"] > 0
    assert out["compiles"] == {0: 0, 1: 0}


def test_train_cli_eager_walks_1f1b_through_a_failure(capsys):
    """--eager: the 1F1B walker trains through the failure; no step
    programs are warmed, and a codec is refused as the reference
    refuses it (the per-layer path syncs uncompressed)."""
    out = train.main(["--steps", "4", "--kill-at", "2", "--layers", "2",
                      "--eager", "--codec", "bf16", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "--eager ignores --codec bf16" in text and "[warm]" not in text
    assert out["losses"][-1] < out["losses"][0]
    assert all(d == 0.0 for d in out["divergences"])
    assert set(out["builds_after_step"]) == {out["recovery"]["builds_before"]}


def test_train_cli_checkpoints_restore(tmp_path):
    """--ckpt-dir --ckpt-every 1: a manifest per step (the last two kept),
    each restoring to a state of the run's shape and step."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.optim import adamw
    out = train.main(["--steps", "3", "--kill-at", "1", "--layers", "2",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "1",
                      "--device", "cpu"])
    assert out["checkpoints"] == [2, 3]
    arch = reduced(get_arch("gpt3-medium"), layers=2)
    template = Model(arch).init(torch.Generator().manual_seed(0))
    mgr = CheckpointManager(str(tmp_path), num_layers=arch.num_layers)
    for step in out["checkpoints"]:
        assert mgr.verify(step)
        got = mgr.restore(template, adamw.init(template), step=step,
                          device="cpu")
        assert got.step == step and int(got.opt_state.step) == step
        assert got.data_state == {"next_index": 16 * step}
        assert got.params["blocks"]["attn"]["wq"].shape == \
            template["blocks"]["attn"]["wq"].shape


def test_train_cli_join_at_exits_as_the_reference_does():
    with pytest.raises(SystemExit, match="HeteroTrainer.join"):
        train.main(["--steps", "2", "--join-at", "1", "--layers", "2",
                    "--device", "cpu"])


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_without_a_card_raises_and_never_falls_back(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        train.main(["--steps", "1"])                 # default device: cuda
    with pytest.raises(RuntimeError):
        params_from_numpy({"w": [1.0]})              # default device: cuda
    with pytest.raises(RuntimeError):                # the coordinator
        train.main(["--procs", "2", "--steps", "1"])
    from repro_torch.runtime.multihost import build_setup, make_job_spec
    with pytest.raises(RuntimeError):                # a worker's setup
        build_setup(make_job_spec())
    with pytest.raises(ValueError):
        resolve_device("meta")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_rehearsal_on_cpu(capsys):
    record = _load_chip_smoke().run("cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == record
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "config",
            "tp_launches", "serve_launches", "bf16"}
    bf16_keys = {"launches", "max_abs_err", "shape", "ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms", "config"}
    # the wgmma instances carry phase 20's QKV GEMM and flash forward and
    # backward: their entries are bf16 and phase 20's; the mma.sync
    # instances' bf16 entries keep phase 20's launches (none) and the
    # configuration
    wgmma = {"gemm_bias_wgmma", "flash_fwd_wgmma", "flash_bwd_dq_wgmma",
             "flash_bwd_dkdv_wgmma", "ssd_fwd_wgmma", "ssd_bwd_wgmma"}
    # the SSD pair's wgmma instances run bf16 alone (phase 20's 20b);
    # ssd.cu's pair keeps phase 8 (fp32 mamba2-780m)
    assert [k["name"] for k in record["kernels"]] == [
        "add_rmsnorm_fwd", "add_rmsnorm_bwd", "gemm_bias", "flash_fwd",
        "flash_bwd_dq", "flash_bwd_dkdv", "ssd_fwd", "ssd_bwd",
        "gemm_bias_wgmma", "flash_fwd_wgmma", "flash_bwd_dq_wgmma",
        "flash_bwd_dkdv_wgmma", "ssd_fwd_wgmma", "ssd_bwd_wgmma"]
    for k in record["kernels"]:
        if k["name"] in wgmma:
            assert set(k) == (keys - {"tp_launches", "serve_launches", "bf16"}
                              | {"dtype", "path", "shape"})
        elif k["name"] in ("gemm_bias", "flash_fwd", "flash_bwd_dq",
                           "flash_bwd_dkdv", "ssd_fwd", "ssd_bwd"):
            assert set(k) == keys and set(k["bf16"]) == {"launches",
                                                         "config"}
        else:
            assert set(k) == keys and set(k["bf16"]) == bf16_keys
        assert (ROOT / k["source"]).exists()
        path, lines_at = k["replaces"].split(":", 1)       # "file:47" or
        for line in lines_at.split("+:"):                   # "file:247+:274"
            src_line = (ROOT / path).read_text().splitlines()[int(line) - 1]
            assert src_line.startswith("def _"), src_line
    assert any("[check] gemm_bias        dW" in ln for ln in lines)
    # bf16 GEMM calls whose rows TMA reads are the wgmma instance's: the
    # mma.sync entry is held in bf16 only where its inputs reach it, rows
    # of K or N elements that are not whole 16-byte units
    cs = _load_chip_smoke()
    assert {ln.split()[3] for ln in lines
            if ln.startswith("[check] gemm_bias ") and "bfloat16" in ln} == {
        label for label, (_, K, N) in cs.CPU_SHAPES["gemm_bias"]
        if (K % 8 or N % 8) and label not in cs.P20_LABELS + cs.SV_LABELS}
    assert any(ln.startswith("[autotune]") and "fresh interpreters resolve "
               "the same" in ln for ln in lines)
    configs = {k["name"]: k["config"] for k in record["kernels"]}
    assert set(configs["gemm_bias"]) == {"fwd", "dx", "dW"}
    assert set(configs["ssd_fwd"]) == {"chunk"}
    for kind in ("flash", "gqa", "window", "tp-a", "tp-b", "tp-c", "tp-d",
                 "tp-e", "tp-f"):
        assert any(ln.startswith("[check] flash_bwd_dkdv") and kind in ln
                   for ln in lines), kind
    # phases 18 and 19's shard shapes
    for label in ("tp-a", "tp-b", "tp-c", "tp-d", "tp-e"):
        for layout in ("fwd", "dx", "dW"):
            assert any(ln.split()[:4] == ["[time]", "gemm_bias", layout, label]
                       and "config {" in ln for ln in lines), (layout, label)
    for name, label in (("add_rmsnorm_bwd", "tp-d"), ("flash_fwd", "tp-f"),
                        ("ssd_fwd", "tp-d"), ("ssd_bwd", "tp-g")):
        assert any(ln.split()[:4] == ["[time]", name, "fwd", label]
                   for ln in lines), (name, label)
    for path in ("flash", "naive"):       # each path's epilogue shapes
        for layout in ("fwd", "dx", "dW"):
            assert any(ln.split()[:4] == ["[time]", "gemm_bias", layout, path]
                       for ln in lines), (layout, path)
        assert any(ln.startswith("[check] add_rmsnorm_bwd") and path in ln
                   for ln in lines), path
    for kind in ("mamba", "hymba", "reduced"):
        for dtype in ("float32", "bfloat16"):
            assert any(ln.startswith("[check] ssd_bwd") and kind in ln
                       and dtype in ln for ln in lines), (kind, dtype)
    for name, dt in (("ssd_fwd", "fp32"), ("ssd_bwd", "fp32"),
                     ("ssd_fwd_wgmma", "bf16"), ("ssd_bwd_wgmma", "bf16")):
        assert any(ln.split()[:4] == ["[time]", name, "fwd", "mamba"]
                   and f"{dt}: kernel" in ln for ln in lines), (name, dt)
    for model in ("mamba2", "hymba", "granite-moe (4", "qwen2-moe",
                  "granite-moe remat", "hymba remat dots",
                  "granite-moe chunked CE"):
        assert any(ln.startswith(f"[model] {model}") for ln in lines), model
    for model in ("granite-moe", "hymba window"):
        assert any(ln.startswith(f"[decode] {model}") for ln in lines), model
    for tag in ("[serve] unfailed:", "[serve] failed at tick 8:",
                "[serve] recovery: downtime", "[serve] greedy stream"):
        assert any(ln.startswith(tag) for ln in lines), tag
    assert any(ln.startswith("[serve] failed at tick") and
               "builds in the trace 0" in ln for ln in lines)
    for name in ("add_rmsnorm_bwd", "gemm_bias", "flash_bwd_dkdv"):
        assert any(ln.startswith(f"[check] {name}") and " moe " in ln
                   for ln in lines), name
    for path in ("naive", "flash", "mamba", "moe"):
        assert any(ln.startswith(f"[{path}]") for ln in lines), path
    for tag in ("A step 3", "B step 3", "eager step 3", "checkpoint:",
                "replica recovery", "equal A's bitwise"):
        assert any(ln.startswith("[lifecycle]") and tag in ln
                   for ln in lines), tag
    for tag in ("leg 1 (one process)", "3 workers spawned", "step 0:",
                "step 3:", "SIGKILL rank 1 -> detected ['n2']",
                "params bitwise leg 1's", "phase"):
        assert any(ln.startswith("[multiproc]") and tag in ln
                   for ln in lines), tag
    for tag in ("= dry-run args less the batch", "vs the trainer's",
                "programs 1, builds after bind 0", "not measured",
                "recover raised ExecutorUnsupported",
                "rebound from the snapshot"):
        assert any(ln.startswith("[spmd]") and tag in ln
                   for ln in lines), tag
    for tag in ("4 rank processes, backend gloo", "= the dry-run's per-card",
                "vs phase 13's", "bitwise on every rank",
                "bytes a step on rank 0", "divergence 0"):
        assert any(ln.startswith("[mesh]") and tag in ln
                   for ln in lines), tag
    for tag in ("4 stage ranks x 2 blocks", "vs one process's plain step",
                "bitwise on every stage", "not measured"):
        assert any(ln.startswith("[pipeline]") and tag in ln
                   for ln in lines), tag
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        for case in ("w0-o0", "w16-o32"):
            assert any(ln.startswith(f"[check] {name}") and " offset " in ln
                       and case in ln for ln in lines), (name, case)
        assert any(ln.startswith(f"[time] {name}") and "Sq=32 Sk=64" in ln
                   for ln in lines), name
    for name, tag in (("17a", "the sequence over model: 1 rows of 16"),
                      ("17b", "the sequence over None: 1 rows of 32"),
                      ("17c", "the sequence over model: 1 rows of 16")):
        assert any(ln.startswith(f"[seq] {name}") and tag in ln
                   for ln in lines), (name, tag)
        assert any(ln.startswith(f"[seq] {name} step seconds") and
                   "bitwise on every rank" in ln for ln in lines), name
    for name in ("18a", "18b", "18c", "19a", "19b", "19c"):
        for tag in ("vs one program's", "bitwise across the model group",
                    "= the dry-run's per-card args less the batch",
                    "the dry-run's all-reduce bytes", "launches a rank"):
            assert any(ln.startswith(f"[tp] {name}") and tag in ln
                       for ln in lines), (name, tag)
    # phase 20's shapes, checked in both dtypes and timed in bf16; the
    # QKV GEMM and flash forward there on their wgmma instances
    for label in ("20a", "20b", "20c", "20d"):
        for layout in ("fwd", "dx", "dW"):
            assert any(ln.split()[:4] == ["[time]", "gemm_bias_wgmma",
                                          layout, label]
                       and "bf16: kernel" in ln for ln in lines), label
        assert any(ln.split()[:4] == ["[time]", "flash_fwd_wgmma", "fwd",
                                      label]
                   and "bf16: kernel" in ln for ln in lines), label
        assert not any(ln.split()[:2] == ["[time]", "flash_fwd"]
                       and f" {label} " in ln for ln in lines), label
        assert any(ln.startswith("[check] flash_bwd_dkdv") and f" {label} "
                   in ln and "bfloat16" in ln for ln in lines), label
    assert any(ln.split()[:4] == ["[time]", "ssd_bwd_wgmma", "fwd", "20b"]
               and "bf16: kernel" in ln for ln in lines)
    for name in ("20a", "20b", "20c", "20d"):
        assert any(ln.startswith(f"[bf16] {name}") and "first bf16 loss" in ln
                   for ln in lines), name
    assert sum(ln.startswith("[bf16] 20") and "rebound from the snapshot" in ln
               for ln in lines) == 2
    # phase 21's prefill shard shapes: the kernels a prefill runs, fp32
    for name, label in (("add_rmsnorm_fwd", "sv-a"), ("gemm_bias", "sv-b"),
                        ("flash_fwd", "sv-c"), ("ssd_fwd", "sv-b")):
        assert any(ln.startswith(f"[check] {name}") and f" {label} " in ln
                   and "float32" in ln for ln in lines), (name, label)
        assert any(ln.split()[:4] == ["[time]", name, "fwd", label]
                   and "config" in ln for ln in lines), (name, label)
    assert not any(ln.startswith("[check] flash_bwd_dq") and " sv-" in ln
                   for ln in lines)
    for tag in ("15b: stage 2 x data 2", "data replicas bitwise equal",
                "15b step seconds"):
        assert any(ln.startswith("[pipeline]") and tag in ln
                   for ln in lines), tag
    for name in ("21a", "21b", "21c"):
        for tag in ("tokens equal one program's", "bitwise on its ranks",
                    "= the count from the shapes on every rank",
                    "vs the spec's shard", "launches a rank",
                    "of the limit", "the ticks launched no kernel"):
            assert any(ln.startswith(f"[mesh-serve] {name}") and tag in ln
                       for ln in lines), (name, tag)
    for name in ("19a", "19b"):            # the mixer's heads a rank
        assert any(ln.startswith(f"[tp] {name}") and "Mamba2 heads (0, 4)"
                   in ln for ln in lines), name
    for name in ("19a", "19b", "19c"):
        assert any(ln.startswith(f"[tp] {name}") and "= the count from the "
                   "shapes on every rank" in ln for ln in lines), name
    # 19c on model 4 with 9 / 3 heads: rank 2's heads straddle two kv
    # groups and run as two flash pieces; the pieces' shapes in phase 3
    assert any(ln.startswith("[tp] 19c flash pieces a block by rank "
                             "[1, 1, 2, 1]: rank 2's query heads (5, 7)")
               for ln in lines)
    assert any(ln.startswith("[tp] 19c hymba_1_5b_smoke") and
               "data 1 x model 4" in ln for ln in lines)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        for label in ("19c-1", "19c-2", "19c-3", "19c-4"):
            assert any(ln.startswith(f"[check] {name}") and f" {label} "
                       in ln and "float32" in ln for ln in lines), (name,
                                                                   label)


def _phase13_batch(cs):
    """Phase 13's global batch in the CPU rehearsal (its byte corpus at
    its CPU sequence)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import ByteCorpus, GlobalBatchDispenser
    from repro_torch.launch.train import _TEXT
    seq = cs.SPMD["cpu_seq_len"]
    engine = cs.spmd_engine(reduced(get_arch("gpt3-medium"), layers=2), seq)
    parts = GlobalBatchDispenser(ByteCorpus(_TEXT * 50, seq_len=seq)
                                 ).next_step(engine.batch.minibatch_sizes())
    return {k: np.concatenate([b[k] for b in parts])
            for k in ("tokens", "labels")}


def test_chip_smoke_phase20_rehearsal_on_cpu(capsys):
    """Phase 20 alone on the CPU: the four scenarios at 2 blocks and
    phase 13's CPU sequence through the plain versions, each first fp32
    loss held to the plain forward (EXECUTOR_TOL) and each first bf16
    loss to it (BF16_LOSS_RTOL); the entry points' calls equal the
    forward half of the launch count the card asserts (a block's forward
    twice a step under remat full: 2 blocks x 2 steps x 2); the pricing
    from its dry-run traces; the kill and rebind of 20a and 20b."""
    cs = _load_chip_smoke()
    launches = cs.run_bf16(torch.device("cpu"), _phase13_batch(cs))
    assert set(launches.values()) == {0}         # no kernel on the CPU
    lines = capsys.readouterr().out.strip().splitlines()
    for name, arch in cs.BF16_MODELS.items():
        head = [ln for ln in lines if ln.startswith(f"[bf16] {name} ")
                and "first bf16 loss" in ln]
        assert len(head) == 1 and arch.replace("-", "_").replace(".", "_") \
            in head[0], name
        gap = float(head[0].split("relative gap to fp32 ")[1].split()[0])
        assert 0 < gap <= cs.BF16_LOSS_RTOL, (name, gap)
        for dtype in cs.BF16_DTYPES:
            want = (8, 8, 8, 8 if name == "20b" else 0)
            assert any(ln.startswith(f"[bf16] {name} {dtype}: bind") and
                       "entry calls {'add_rmsnorm_fwd': %d, 'gemm_bias': %d, "
                       "'flash_fwd': %d, 'ssd_fwd': %d}" % want in ln
                       for ln in lines), (name, dtype)
            assert any(ln.startswith(f"[bf16] {name} {dtype}: peak memory")
                       and "not measured" in ln and "predicted peak" in ln
                       for ln in lines), (name, dtype)
    assert cs.seq_launches(cs.bf16_model(False, "20b", "bfloat16")[0], 2) == {
        "add_rmsnorm_fwd": 8, "flash_fwd": 8, "add_rmsnorm_bwd": 4,
        "flash_bwd_dq": 4, "flash_bwd_dkdv": 4, "gemm_bias": 16,
        "ssd_fwd": 8, "ssd_bwd": 4}
    assert [ln.split()[1] for ln in lines
            if "rebound from the snapshot" in ln] == ["20a", "20b"]


@pytest.mark.parametrize("fault", ["loss", "launches"])
def test_chip_smoke_phase20_checks_catch_planted_faults(fault, monkeypatch):
    """A bf16 loss further from fp32 than the tolerance, or a launch
    count the entry points do not make, fails the scenario."""
    cs = _load_chip_smoke()
    if fault == "loss":
        monkeypatch.setattr(cs, "BF16_LOSS_RTOL", 1e-9)
        match = "relative gap"
    else:
        real = cs.seq_launches
        monkeypatch.setattr(cs, "seq_launches", lambda arch, steps: {
            k: v + 1 for k, v in real(arch, steps).items()})
        match = "entry calls"
    with pytest.raises(cs.SmokeFailure, match=match):
        cs._bf16_scenario(torch.device("cpu"), "20c", _phase13_batch(cs))


def _zero(i):
    return lambda out: tuple(torch.zeros_like(t) if j == i else t
                             for j, t in enumerate(out))


@pytest.mark.parametrize("name,shape,fault", [
    ("flash_fwd", (1, 100, 4, 2, 32, 0), _zero(0)),
    ("flash_bwd_dq", (1, 100, 4, 2, 32, 0), lambda dq: dq * 1.05),
    ("flash_bwd_dkdv", (1, 100, 4, 2, 32, 0), _zero(0)),
    ("flash_bwd_dkdv", (1, 100, 4, 1, 32, 24), _zero(1)),
    ("add_rmsnorm_bwd", (256, 64), _zero(1)),
    ("ssd_bwd", (2, 130, 3, 64, 16, True), _zero(3)),
    ("ssd_bwd", (2, 130, 3, 64, 16, True), _zero(1)),
    ("ssd_bwd", (2, 130, 3, 64, 16, True),
     lambda out: (out[0] * 1.05, *out[1:])),
], ids=["out-zeroed", "dq-5pct", "dk-zeroed", "dv-zeroed-window", "dw-zeroed",
        "ssd-dB-zeroed", "ssd-ddt-zeroed", "ssd-dx-5pct"])
def test_chip_smoke_bf16_checks_catch_planted_faults(name, shape, fault):
    """The bf16 comparison of outputs that are sums of many terms holds
    them to 2e-2 of their value plus 1e-3 of their condition-aware
    scale (the fp32 ones, as the SSD's ddt, to 1e-4 plus 1e-5 of it): a
    zeroed or 5 %-scaled output fails it."""
    cs = _load_chip_smoke()
    cpu = torch.device("cpu")
    _, plain, _ = cs.kernel_table(cpu)[name]
    args = cs.make_inputs(name, shape, torch.bfloat16, cpu, seed=1)
    cs.compare(name, plain, plain, args, torch.bfloat16)
    with pytest.raises(cs.SmokeFailure, match="elements off"):
        cs.compare(name, lambda *a: fault(plain(*a)), plain, args,
                   torch.bfloat16)


def test_chip_smoke_fails_without_a_card_or_the_repository(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120,
                           env=env)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout


def test_model_init_draws_on_the_generator_device():
    model = Model(reduced(get_arch("gpt3_medium"), layers=1))
    params = model.init(torch.Generator(device="cpu").manual_seed(0))
    again = model.init(torch.Generator(device="cpu").manual_seed(0))
    assert params["embed"]["table"].device.type == "cpu"
    assert torch.equal(params["blocks"]["attn"]["wq"],
                       again["blocks"]["attn"]["wq"])
