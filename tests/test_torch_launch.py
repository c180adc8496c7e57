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


@pytest.mark.parametrize("policy", ["replan", "adapt"])
def test_train_cli_on_cpu_recovers_without_builds(policy, capsys):
    out = train.main(["--steps", "4", "--kill-at", "2", "--layers", "2",
                      "--recovery-policy", policy, "--device", "cpu"])
    text = capsys.readouterr().out
    for tag in ("[plan]", "[sync]", "[warm]", "[fail]", "[step 3]", "[done]"):
        assert tag in text, tag
    assert out["losses"][-1] < out["losses"][0]
    assert all(d == 0.0 for d in out["divergences"])
    assert out["recovery"]["policy"] == policy
    assert set(out["builds_after_step"]) == {out["recovery"]["builds_before"]}


@pytest.mark.parametrize("flag", [["--procs", "2"], ["--eager"],
                                  ["--ckpt-dir", "x"], ["--join-at", "1"]])
def test_later_slice_flags_raise(flag):
    with pytest.raises(NotImplementedError):
        train.main(["--steps", "1", "--device", "cpu", *flag])


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
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in record["kernels"]] == [
        "add_rmsnorm_fwd", "add_rmsnorm_bwd", "gemm_bias"]
    for k in record["kernels"]:
        assert set(k) == keys
        assert (ROOT / k["source"]).exists()
        path, line = k["replaces"].split(":")
        src_line = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert src_line.startswith("def _"), src_line
    assert any("[check] gemm_bias        dW" in ln for ln in lines)
    assert any(ln.startswith("[main]") for ln in lines)


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
