"""The exported grounding program (``tools/export_model.py``,
``serve.py``) on the CPU: the ``.pt2`` round trip against the live port
program, the live program against the JAX ``build_serve_fn`` on the same
inputs and weights, and the CLI with ``--random-init --check``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.tools import export_model as jexport
from dropclip_tpu_torch.convert import student_trees
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.distill.engine import build_student_for
from dropclip_tpu_torch.serve import load_exported
from dropclip_tpu_torch.tools import export_model

NQ, NNEG = 4, 3
CFG = dict(arch_3d="tiny", feat_dim=16, use_color=True, voxel_capacity=256,
           sparse_backend="bricks", brick_shape=[4, 4, 2],
           sim_method="paired", sim_norm_thresh=0.75)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """This file's torch ops in two threads: the tier-1 run shares the
    box's cores among several test processes, where more threads only
    wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny student (seeded weights, BN statistics moved off their
    initial values) exported on the CPU, and the artifact's path."""
    cfg = CfgNode(dict(CFG))
    model = build_student_for(cfg, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.add_(0.1 if name.endswith("mean") else 0.5)
    path = str(tmp_path_factory.mktemp("export") / "serve.pt2")
    ep = export_model.export_serve(cfg, model, path, NQ, NNEG, "cpu")
    return cfg, model, path, ep


def test_pt2_round_trip_matches_live_program(exported):
    """``serve.load_exported`` of the saved artifact against the live
    program on inputs other than the trace's: masks equal, sims within
    2e-5 (the JAX ``--check`` limits), ``dropped`` equal; K1 is one
    registered op per k3 conv in the exported graph (16)."""
    cfg, model, path, ep = exported
    k1 = [n for n in ep.graph.nodes if "dropclip.brick_conv3" in str(n.target)]
    assert len(k1) == 16
    run = load_exported(path)
    live = export_model.ServeProgram(cfg, model)
    for seed in (1, 2):
        inputs = export_model.example_inputs(cfg, NQ, NNEG, seed=seed,
                                              device="cpu")
        with torch.no_grad():
            got, want = run(*inputs), live(*inputs)
        assert got[0].dtype == torch.bool and got[0].shape == (NQ, 256)
        assert got[1].shape == (NQ, 256) and got[2].shape == ()
        assert torch.equal(got[0], want[0])
        np.testing.assert_allclose(got[1].numpy(), want[1].numpy(),
                                   rtol=2e-5, atol=2e-5)
        assert int(got[2]) == int(want[2])
        assert bool(want[0].any()) and int(want[0].sum()) < want[0].numel()


def test_exported_graph_holds_no_profiler_op(exported):
    """The serve program's trace records no span (``core/spans.py``) and
    no other profiler op: the spans sit outside the traced functions."""
    _, _, _, ep = exported
    targets = [str(n.target) for n in ep.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record" in t]


def test_live_program_matches_jax_build_serve_fn(exported):
    """The port's live serve program against the JAX ``build_serve_fn``
    (jitted) on the same inputs, with the port student's weights handed
    to JAX as flax trees (``convert.student_trees``): masks equal, sims
    within 1e-5, ``dropped`` equal."""
    cfg, model, _, _ = exported
    params, stats = student_trees(model.state_dict())
    jfn = jax.jit(jexport.build_serve_fn(
        JCfg(dict(CFG)), {"params": params, "batch_stats": stats}, NQ, NNEG))
    live = export_model.ServeProgram(cfg, model)
    inputs = export_model.example_inputs(cfg, NQ, NNEG, seed=4,
                                          device="cpu")
    with torch.no_grad():
        got = live(*inputs)
    want = jfn(*(jnp.asarray(t.numpy()) for t in inputs))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    assert int(got[2]) == int(want[2])


def test_export_cli_random_init_check(tmp_path, capsys):
    """``python -m dropclip_tpu_torch.tools.export_model --random-init
    --check --device cpu``: the artifact written, and its round trip
    against the live program passes."""
    out = str(tmp_path / "m.pt2")
    rc = export_model.main([
        "--config", "configs/DistilBlender.yaml", "--random-init", "--out",
        out, "--check", "--device", "cpu", "--nq", "2", "--nneg", "2",
        "--opts", "arch_3d", "tiny", "feat_dim", "16", "voxel_capacity",
        "128"])
    text = capsys.readouterr().out
    assert rc == 0 and "16 K1 ops" in text
    assert "roundtrip check ok" in text
