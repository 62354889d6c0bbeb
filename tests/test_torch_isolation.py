"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry point never drops to the CPU on its own."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

SRC = Path(__file__).resolve().parent.parent / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    run = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    n_modules, leaked = run.stdout.split(" ", 1)
    assert int(n_modules) >= 34
    assert leaked.strip() == "[]"


def test_serve_raises_without_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(["--smoke", "--requests", "1", "--gen", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.resolve_device("cuda:0")
    assert tserve.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("argv,match", [
    (["--engine", "dense"], "--engine dense"),
    (["--mesh", "prod"], "--mesh"),
    (["--arch", "zamba2-7b"], "not yet ported"),
])
def test_serve_parts_not_ported_yet_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        tserve.serve(argv + ["--smoke", "--device", "cpu"])


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


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "host"], "--mesh"),
    (["--checkpoint-dir", "ckpt"], "--checkpoint-dir"),
    (["--inject", "nan-grad@3"], "--inject"),
    (["--accum", "2"], "--accum"),
    (["--remat", "dots"], "--remat dots"),
    (["--optimizer", "adamw"], "adamw"),
    (["--optimizer", "badam"], "badam"),
    (["--arch", "gemma2-27b"], "not yet ported"),
])
def test_train_parts_not_ported_yet_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        ttrain.train(argv + ["--smoke", "--device", "cpu", "--steps", "1"])
