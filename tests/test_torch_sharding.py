"""The port's sharding specs and launch layer (``repro_torch.runtime.
sharding``, ``repro_torch.launch.{mesh,specs,dryrun}``).

The cases of tests/test_launch.py:19-155 run against the port's modules;
then full-width parity: for every ``all_cells()`` cell on both production
meshes under both strategies, every parameter, ZeRO-1 moment, batch and
cache spec equals the reference's ``PartitionSpec`` entry for entry, and
the per-device argument bytes the port derives from its specs equal the
sums over the reference bundles' shardings.  The reference's side comes
from ONE subprocess with 512 forced host devices (the XLA flag must be
set before jax is imported), built from its bundles without a compile.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import SHAPES, all_archs, all_cells, cells_for, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (data_axes, group_bandwidth,
                                     make_production_mesh)
from repro_torch.models import Model
from repro_torch.runtime.sharding import ShardingStrategy, spec_leaves
from repro_torch.utils.hw import H100

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT = int(os.environ.get("REPRO_DRYRUN_TIMEOUT", "600"))


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def test_mesh_module_import_is_pure():
    """Importing mesh.py starts no process group and touches no device."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import repro_torch.launch.mesh as m\n"
            "import torch.distributed as d\n"
            "mesh = m.make_production_mesh(multi_pod=True)\n"
            "print(d.is_initialized(), m.mesh_chips(mesh), dict(mesh.shape))"
            % SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout.strip()
    assert out == "False 512 {'pod': 2, 'data': 16, 'model': 16}"


def test_cell_enumeration():
    cells = all_cells()
    assert len(cells) == 32          # 10 archs x 3 shapes + 2 long_500k
    names = {(a.name, s.name) for a, s in cells}
    assert ("mamba2_780m", "long_500k") in names
    assert ("hymba_1_5b", "long_500k") in names
    assert ("qwen2_5_32b", "long_500k") not in names


def test_input_specs_shapes():
    arch = get_arch("phi3_vision_4_2b")
    b = sp.batch_specs(arch, SHAPES["train_4k"])
    # frontend tokens are carved out of the text sequence
    assert b["tokens"].shape == (256, 4096 - 576)
    assert b["frontend_embeds"].shape == (256, 576, 3072)
    assert b["frontend_embeds"].dtype == torch.bfloat16
    assert all(v.device.type == "meta" for v in b.values())
    assert "labels" not in sp.prefill_specs(arch, SHAPES["prefill_32k"])
    tok, cache, pos = sp.decode_specs(arch, SHAPES["decode_32k"],
                                      Model(arch))
    assert tok.shape == (128, 1) and pos.shape == ()
    assert cache["attn"]["k"].shape == (arch.num_layers, 128, 32768,
                                        arch.num_kv_heads, arch.head_dim)


@pytest.mark.parametrize("strategy", ["fsdp", "tp"])
def test_param_spec_divisibility_guard(strategy):
    st = ShardingStrategy(strategy=strategy)
    mesh = FakeMesh({"data": 16, "model": 16})
    spec = st.param_spec(mesh, "blocks/attn/wq", (28, 2048, 2048))
    assert "model" in spec
    spec = st.param_spec(mesh, "blocks/attn/wq", (28, 2047, 2047))
    assert all(s is None for s in spec)


def test_tp_row_col_assignment():
    st = ShardingStrategy(strategy="tp")
    mesh = FakeMesh({"data": 16, "model": 16})
    wq = st.param_spec(mesh, "blocks/attn/wq", (28, 2048, 4096))
    assert wq[2] == "model" and wq[1] is None      # column parallel
    wo = st.param_spec(mesh, "blocks/attn/wo", (28, 4096, 2048))
    assert wo[1] == "model" and wo[2] is None      # row parallel
    emb = st.param_spec(mesh, "embed/table", (151936, 2048))
    assert emb[0] == "model"                       # vocab sharded


def test_fsdp_batch_axes_include_model():
    st = ShardingStrategy(strategy="fsdp", data_axes=("pod", "data"))
    assert st.batch_axes == ("pod", "data", "model")
    st2 = ShardingStrategy(strategy="tp", data_axes=("data",))
    assert st2.batch_axes == ("data",)


def test_batch_spec_prefix_fallback():
    st = ShardingStrategy(strategy="fsdp", data_axes=("pod", "data"))
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert st.batch_spec(mesh, 512) == (("pod", "data", "model"),)
    assert st.batch_spec(mesh, 256) == (("pod", "data"),)  # 256 % 512 != 0
    assert st.batch_spec(mesh, 2) == ("pod",)
    assert st.batch_spec(mesh, 1) == ()
    assert st.seq_axis(mesh, 256) == "model"
    assert st.seq_axis(mesh, 512) is None


def test_model_flops_definitions():
    arch = get_arch("qwen2_moe_a2_7b")
    tr = dryrun.model_flops(arch, SHAPES["train_4k"])
    # MoE uses ACTIVE params
    assert tr == pytest.approx(6 * arch.active_params() * 4096 * 256)
    de = dryrun.model_flops(arch, SHAPES["decode_32k"])
    assert de == pytest.approx(2 * arch.active_params() * 128)


def test_collectives_price_nvlink_within_a_board_and_the_network_beyond():
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    # a 16-wide model axis spans two 8-card boards; data and pod span more
    for mesh, axis in ((single, "model"), (single, "data"),
                       (multi, ("pod", "data")), (multi, "pod")):
        assert group_bandwidth(mesh, axis) == H100.dcn_bandwidth
    mini = FakeMesh({"data": 2, "model": 4})
    assert group_bandwidth(mini, "model") == H100.ici_bandwidth
    assert group_bandwidth(mini, ("data", "model")) == H100.ici_bandwidth
    # the data axis of a 2 x 8 mesh strides across two boards
    assert group_bandwidth(FakeMesh({"data": 2, "model": 8}),
                           "data") == H100.dcn_bandwidth


# ----------------------------------------------------------------------
# Full-width parity against the reference's bundles
# ----------------------------------------------------------------------
REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, math
    import jax
    from repro.configs import all_archs, cells_for
    from repro.launch import specs as sp
    from repro.launch.mesh import data_axes, make_production_mesh
    from repro.optim import adamw
    from repro.runtime import spmd
    from repro.runtime.sharding import ShardingStrategy, _key_name

    def enc(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def specs(tree):
        out = {}
        for path, ns in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out["/".join(_key_name(k) for k in path)] = enc(ns.spec)
        return out

    def nbytes(shardings, shapes):
        return sum(math.prod(ns.shard_shape(s.shape)) * s.dtype.itemsize
                   for ns, s in zip(jax.tree.leaves(shardings),
                                    jax.tree.leaves(shapes)))

    out = {}
    shapes = {}    # the trees' shapes do not depend on the layout
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for name in ("fsdp", "tp"):
            st = ShardingStrategy(strategy=name, data_axes=data_axes(multi))
            for arch in all_archs():
                model = spmd.build_model(arch, st, mesh, 1)
                if arch.name not in shapes:
                    ps = sp.params_shape(model)
                    shapes[arch.name] = (ps, sp.opt_shape(model, ps), {})
                pshape, oshape, caches = shapes[arch.name]
                key = f"{arch.name}/{'multi' if multi else 'single'}/{name}"
                rec = {"params": specs(st.param_shardings(mesh, pshape)),
                       "m": specs(st.opt_shardings(mesh, oshape, pshape).m),
                       "cells": {}}
                for shape in cells_for(arch):
                    cell = {"batch": enc(st.batch_spec(mesh,
                                                       shape.global_batch))}
                    if shape.kind == "train":
                        b = spmd.train_bundle(model, adamw.AdamWConfig(), st,
                                              mesh, pshape, oshape, shape)
                        args = (pshape, oshape, sp.batch_specs(arch, shape))
                    elif shape.kind == "prefill":
                        b = spmd.prefill_bundle(model, st, mesh, pshape,
                                                shape)
                        args = (pshape, sp.prefill_specs(arch, shape))
                    else:
                        if shape.name not in caches:
                            caches[shape.name] = sp.decode_specs(arch, shape,
                                                                 model)
                        tok, cache, pos = caches[shape.name]
                        b = spmd.decode_bundle(model, st, mesh, pshape,
                                               cache, shape)
                        args = (pshape, tok, cache, pos)
                        cell["cache"] = specs(b.in_shardings[2])
                    cell["args"] = nbytes(b.in_shardings, args)
                    rec["cells"][shape.name] = cell
                out[key] = rec
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT],
                         capture_output=True, text=True, env=env,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _specs(specs, like):
    return {p: _enc(s) for p, s, _ in spec_leaves(specs, like)}


@pytest.mark.parametrize("strategy", ["fsdp", "tp"])
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch_name", [a.name for a in all_archs()])
def test_specs_and_arg_bytes_equal_the_reference(reference, arch_name,
                                                 mesh_kind, strategy):
    multi = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi)
    st = ShardingStrategy(strategy=strategy, data_axes=data_axes(multi))
    arch = get_arch(arch_name)
    model = Model(arch)
    ref = reference[f"{arch_name}/{mesh_kind}/{strategy}"]
    pshape = sp.params_shape(model)
    oshape = sp.opt_shape(model, pshape)
    assert _specs(st.param_shardings(mesh, pshape), pshape) == ref["params"]
    assert _specs(st.opt_shardings(mesh, oshape, pshape).m,
                  pshape) == ref["m"]
    assert set(ref["cells"]) == {s.name for s in cells_for(arch)}
    for shape in cells_for(arch):
        cell = ref["cells"][shape.name]
        assert _enc(st.batch_spec(mesh, shape.global_batch)) == cell["batch"]
        if shape.kind == "decode":
            cache = sp.cache_shape(model, shape)
            assert _specs(st.cache_shardings(mesh, cache, shape.global_batch),
                          cache) == cell["cache"]
        got = dryrun.spec_bytes(arch, shape, mesh, st, model=model)
        assert got["args"] == cell["args"], (shape.name, got, cell["args"])
