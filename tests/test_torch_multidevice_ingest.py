"""Multi-card ingest of the port (``tools/preprocess_data.py
--n-devices``): scenes dealt round-robin over worker threads, each with a
teacher replica from ``ClipExtractor.on_device``. On the CPU
(``--device cpu``) N workers run on the CPU, the counterpart of the 8
forced host devices that tests/test_multidevice_ingest.py gives the JAX
package; their files must equal the one-worker run's. Also: the replica's
contract, the clamp to the local cards, and the launch counters under
concurrent updates."""

import argparse
import os
import sys
import threading

import h5py
import numpy as np
import torch

from dropclip_tpu_torch.kernels import count_launch
from dropclip_tpu_torch.tools import preprocess_data as tpre


def _args(out, n_devices, fmt="h5py"):
    return argparse.Namespace(
        out=out, split="train", n_scenes=3, n_views=3, voxel_size=0.02,
        batch_size=8, clip_model="tiny-test", clip_checkpoint="random",
        visual_prompt="crop-mask", crop_num_levels=1,
        crop_expansion_ratio=0.15, n_devices=n_devices, device="cpu",
        format=fmt)


def _read_all(out):
    scenes = {}
    split_dir = os.path.join(out, "train")
    for sid in sorted(os.listdir(split_dir)):
        with h5py.File(os.path.join(split_dir, sid, f"{sid}.h5py"),
                       "r") as f:
            scenes[sid] = {f"{a}/{b}": np.asarray(f[a][b])
                           for a in f for b in f[a]}
    return scenes


def test_two_cpu_workers_match_one(tmp_path, capsys):
    """``run_synthetic`` at tiny-test: two CPU workers write the files of
    the one-worker run, every dataset equal; both workers ran, and each
    returns its scenes' (path, stats)."""
    seq, par = str(tmp_path / "seq"), str(tmp_path / "par")
    one = tpre.run_synthetic(_args(seq, 1))
    capsys.readouterr()
    two = tpre.run_synthetic(_args(par, 2))
    out = capsys.readouterr().out
    assert "[dev0]" in out and "[dev1]" in out
    assert "local devices" not in out
    a, b = _read_all(seq), _read_all(par)
    assert a.keys() == b.keys() and len(a) == 3
    for sid in a:
        assert a[sid].keys() == b[sid].keys()
        for key in a[sid]:
            np.testing.assert_array_equal(
                a[sid][key], b[sid][key],
                err_msg=f"{sid}/{key} differs between 1 and 2 workers")
    assert [p for p, _ in one] == [p.replace(par, seq) for p, _ in two]
    for (_, s1), (_, s2) in zip(one, two):
        assert {k: s1[k] for k in s2} == s2


def test_cli_n_devices_on_cpu(tmp_path, capsys):
    """``-ds Synthetic --n-devices 3 --device cpu --format npz`` through
    ``main``: three workers, scenes round-robin, .npz files."""
    tpre.main(["-ds", "Synthetic", "-c", str(tmp_path), "--n-scenes", "4",
               "--n-views", "2", "--clip-model", "tiny-test",
               "--voxel-size", "0.02", "--device", "cpu", "--format", "npz",
               "--n-devices", "3"])
    out = capsys.readouterr().out
    for sid, w in (("000000", 0), ("000001", 1), ("000002", 2),
                   ("000003", 0)):
        assert f"{sid} [dev{w}]" in out
        assert os.path.isfile(tmp_path / "train" / sid / f"{sid}.npz")


def test_on_device_replica_isolated():
    """``on_device`` puts the replica's parameters on the target device
    (here the meta device, which needs no card), shares the settings, and
    leaves the original on its device with its own parameters."""
    ex = tpre.build_extractor(argparse.Namespace(
        clip_model="tiny-test", clip_checkpoint="random",
        visual_prompt="crop-mask", crop_num_levels=1,
        crop_expansion_ratio=0.15, batch_size=8), device="cpu")
    rep = ex.on_device("meta")
    assert rep.device == torch.device("meta")
    assert all(p.device.type == "meta" for p in rep.model.parameters())
    assert all(p.device.type == "cpu" for p in ex.model.parameters())
    assert ex.device == torch.device("cpu") and rep.model is not ex.model
    for name in ("visual_prompt", "crop_num_levels", "crop_expansion_ratio",
                 "img_resize", "batch_size", "chunk", "mode", "patch_hw"):
        assert getattr(rep, name) == getattr(ex, name), name
    twin = ex.on_device("cpu")
    p0, p1 = next(ex.model.parameters()), next(twin.model.parameters())
    assert torch.equal(p0, p1) and p0.data_ptr() != p1.data_ptr()


def test_workers_clamped_to_local_cards(monkeypatch, capsys):
    """Asked for more cards than the host has, the workers are clamped to
    the local cards with the JAX package's warning; CPU workers are not
    clamped."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    devs = tpre._local_devices(torch.device("cuda"), 2)
    assert devs == [torch.device("cuda", 0)]
    assert ("WARNING: --n-devices 2 > 1 local devices; using 1"
            in capsys.readouterr().out)
    assert tpre._local_devices(torch.device("cpu"), 4) == \
        [torch.device("cpu")] * 4
    assert capsys.readouterr().out == ""


def test_launch_counter_under_threads():
    """Eight threads count 20000 launches each on one counter with the
    interpreter switching threads every microsecond: no update is lost
    (each worker of a multi-card ingest counts its own launches on the
    shared K3, K6 and K7 counters)."""
    counter = argparse.Namespace(launches=0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [count_launch(counter) for _ in range(20000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.launches == 8 * 20000
