"""The port stands alone: it imports neither JAX nor the JAX package (nor
the ``msgpack`` and ``ml_dtypes`` packages the JAX package's checkpoints
are written with), and its entry point never drops to the CPU on its
own."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.subtrack import tree_leaves
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import MeshLostError
from torch_threads import one_thread  # noqa: F401


SRC = Path(__file__).resolve().parent.parent / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                       "ml_dtypes", "zstandard"))
print(len(names), leaked)
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    """Also none of msgpack, ml_dtypes and zstandard: the checkpoint
    manager reads a zstd leaf through zstandard only when it meets one."""
    run = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    n_modules, leaked = run.stdout.split(" ", 1)
    assert int(n_modules) >= 51
    assert leaked.strip() == "[]"


_IMPORT_MESH = """
import importlib, sys
for name in ("repro_torch.distributed.context",
             "repro_torch.distributed.sharding",
             "repro_torch.kernels.traffic", "repro_torch.launch.mesh",
             "repro_torch.core.program"):
    importlib.import_module(name)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_multi_gpu_modules_load_no_jax_and_no_repro():
    """The mesh context, the sharded layouts, the traffic model's copy,
    the mesh constructors and the StepProgram IR, imported on their own."""
    run = subprocess.run([sys.executable, "-c", _IMPORT_MESH],
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]"


def test_serve_raises_without_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(["--smoke", "--requests", "1", "--gen", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.resolve_device("cuda:0")
    assert tserve.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("argv,exc,match", [
    (["--mesh", "prod"], NotImplementedError, "--mesh"),
    # every arch id of the JAX package is ported: an unknown one raises
    # the JAX package's error
    (["--arch", "no-such-arch"], ValueError, "unknown arch"),
])
def test_serve_parts_not_ported_yet_raise(argv, exc, match):
    with pytest.raises(exc, match=match):
        tserve.serve(argv + ["--smoke", "--device", "cpu"])


def test_serve_falls_back_to_dense_as_the_jax_driver_does(monkeypatch,
                                                          capsys):
    """A config the paged engine refuses goes to the dense engine with the
    JAX package's fallback line; a pure sliding-window config then serves
    from the dense engine's ring cache (window 4, past which the request
    runs)."""
    get = tserve.get_config
    monkeypatch.setattr(tserve, "get_config", lambda *a, **kw: get(
        *a, **kw).with_(sliding_window=4))
    out = tserve.serve(["--smoke", "--device", "cpu", "--requests", "1",
                        "--prompt-len", "6", "--gen", "3"])
    assert "falling back to dense" in capsys.readouterr().out
    assert out["engine"] == "dense" and out["tokens"] == 3


def test_train_raises_without_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--smoke", "--rank", "32", "--steps", "1", "--batch", "2",
            "--seq", "8"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(argv)
    assert ttrain.train(argv + ["--device", "cpu"])["device"] == "cpu"


def test_train_grad_fused_is_ported_and_stays_on_the_asked_device(
        monkeypatch):
    """--grad-fused runs (it raised "not yet ported" before its slice)
    and, like every path, needs a card unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--smoke", "--rank", "32", "--steps", "2", "--batch", "2",
            "--seq", "8", "--grad-fused", "--use-kernels"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(argv)
    out = ttrain.train(argv + ["--device", "cpu"])
    assert out["grad_fused"] and out["device"] == "cpu"
    assert all(v == 0 for v in out["launch_counts"].values())


_SMALL_SERVE = ["--smoke", "--requests", "3", "--batch", "2",
                "--prompt-len", "9", "--gen", "3"]
# the default rank (128) makes every smoke leaf dense: no SVD warm start,
# which dominates these runs' CPU time; tests/test_torch_train.py runs
# --accum and remat dots over low-rank leaves against the JAX package
_SMALL_TRAIN = ["--smoke", "--steps", "1", "--batch", "2", "--seq", "8"]


@pytest.mark.parametrize("entry,argv", [
    ("serve", ["--engine", "dense"]),
    ("train", ["--accum", "2"]),
    ("train", ["--remat", "dots"]),
    ("train", ["--optimizer", "adamw"]),
    ("train", ["--optimizer", "badam"]),
])
def test_ported_flags_run_on_the_asked_device(monkeypatch, entry, argv):
    """Flags ported since the first slices (each raised "not yet ported"
    before its slice) run at smoke size on the CPU when it is asked for,
    and, like every path, need a card otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = tserve.serve if entry == "serve" else ttrain.train
    argv = (_SMALL_SERVE if entry == "serve" else _SMALL_TRAIN) + argv
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(argv)
    out = run(argv + ["--device", "cpu"])
    if entry == "serve":
        assert out["engine"] == "dense" and out["tokens"] == 9
        assert out["peak_memory_bytes"] is None
        return
    assert out["device"] == "cpu" and all(np.isfinite(out["losses"]))
    assert all(v == 0 for v in out["launch_counts"].values())
    # a dense baseline has no subspace to warm-start
    assert (out["warm_start_s"] is None) == ("--optimizer" in argv)
    tensors = tree_leaves(out["state"].params) + [
        t for st in tree_leaves(out["state"].opt.inner) for t in st]
    assert all(t.device.type == "cpu" for t in tensors)


# each case keeps the name it was first registered under (its id)
@pytest.mark.parametrize("argv,exc,match", [
    (["--mesh", "prod"], NotImplementedError,
     "--mesh prod needs a world of 256"),
    # dev-loss is ported: as the JAX driver, a lost mesh with no
    # --checkpoint-dir has nothing to fail over from
    (["--inject", "dev-loss@0"], MeshLostError, "no --checkpoint-dir"),
    # every arch id of the JAX package is ported: an unknown one raises
    # the JAX package's error
    (["--arch", "no-such-arch"], ValueError, "unknown arch"),
    (["--mesh", "multipod"], NotImplementedError,
     "--mesh multipod needs a world of 512"),
    # a mesh over part of the world is ported; one past it raises
    (["--mesh", "host", "--mesh-devices", "2"], ValueError,
     "--mesh-devices 2 on a world of 1"),
    # the step deadline is ported: the run takes it on the CPU
    (["--step-timeout", "30"], None, None),
], ids=["argv0-NotImplementedError---mesh prod needs a world of 256",
        "argv1-NotImplementedError---inject",
        "argv2-ValueError-unknown arch",
        "argv3-NotImplementedError---mesh multipod needs a world of 512",
        "argv4-NotImplementedError---mesh-devices",
        "argv5-NotImplementedError---step-timeout"])
def test_train_parts_not_ported_yet_raise(argv, exc, match):
    """The train CLI's flags as the JAX package's takes them: what is not
    ported yet raises, and so does what the reference refuses."""
    argv = argv + ["--smoke", "--device", "cpu", "--steps", "1"]
    if exc is None:
        out = ttrain.train(argv)
        assert out["device"] == "cpu" and all(np.isfinite(out["losses"]))
        return
    with pytest.raises(exc, match=match):
        ttrain.train(argv)
