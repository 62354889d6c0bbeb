"""The runtime around the training step, end to end through the port's
CLI on the CPU (``repro_torch.launch.train.train``), as the JAX package's
``tests/test_health.py`` ladder cases and ``tests/test_train_loop.py``
restart case drive the JAX driver:

* nan-grad is quarantined: the losses up to and including the injected
  step equal the uninjected run's, and training continues;
* loss-spike climbs skip -> refresh -> rollback to the known-good
  checkpoint, once, and the loss recovers to the uninjected run's
  neighbourhood;
* sigma-blowup sets ``theta_clamped`` with no quarantine; corrupt-batch
  is skip-marked and struck; ckpt-io-error is absorbed by the retry;
  slow-host trips the straggler watchdog;
* fail-at-step, then a restart, reproduces the uninterrupted losses
  within rtol 1e-4 with no warm start; a self-delivered preempt leaves a
  known-good checkpoint and a RESUME marker, and the next start consumes
  the marker and resumes where the preempted run stopped;
* a checkpoint the JAX package wrote resumes the port's CLI, elastic
  from rank 8 to the run's rank 4, with no warm start.
"""

import signal

import jax
import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import transpose as jxp
from repro.configs.registry import get_config as jax_get_config
from repro.core.api import get_optimizer as jax_get_optimizer
from repro.core.lowrank_adam import MatrixOptState as JMatrixOptState
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import checkpoint_descriptors as jax_descriptors
from repro.models.api import build_model as jax_build_model
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.train import train
from torch_threads import one_thread  # noqa: F401


ARGS = ["--arch", "llama-60m", "--smoke", "--batch", "4", "--seq", "32",
        "--update-interval", "4", "--rank", "8", "--warmup", "2",
        "--log-every", "100", "--device", "cpu"]
SHORT = ["--steps", "14", "--lr", "1e-3"]


@pytest.fixture(scope="module")
def ref():
    """The uninjected, uninterrupted 14-step run."""
    return train(ARGS + SHORT)


def _losses(out) -> dict:
    return {h["step"]: h["loss"] for h in out["history"]}


def test_nan_grad_is_quarantined(ref):
    out = train(ARGS + SHORT + ["--inject", "nan-grad@7"])
    assert out["quarantined_steps"] == [7] and out["rollbacks"] == 0
    assert all({"quarantined", "theta_clamped"} <= h.keys()
               for h in out["history"])
    got, want = _losses(out), _losses(ref)
    for s in range(8):       # the true loss of step 7 reaches the metrics
        assert got[s] == want[s], s
    assert got[8] != want[8]  # step 7's update was dropped
    assert [e["action"] for e in out["sentinel_events"]] == ["skip"]
    assert np.isfinite(out["final_loss"])


def test_loss_spike_rolls_back_once_and_recovers(tmp_path):
    steps = ["--steps", "40", "--lr", "3e-3", "--checkpoint-every", "8"]
    base = train(ARGS + steps)
    out = train(ARGS + steps + ["--checkpoint-dir", str(tmp_path),
                                "--inject", "loss-spike@18"])
    assert out["rollbacks"] == 1 and not out["quarantined_steps"]
    assert [e["action"] for e in out["sentinel_events"]] == \
        ["skip", "refresh", "rollback"]
    assert all("spike" in e["reason"] for e in out["sentinel_events"])
    # the rollback replays from the known-good step 16
    steps_run = [h["step"] for h in out["history"]]
    assert steps_run.count(17) == 2
    spiked = max(h["loss"] for h in out["history"])
    assert out["final_loss"] < spiked - 1.0
    assert abs(out["final_loss"] - base["final_loss"]) < 0.75


def test_sigma_blowup_is_clamped_without_quarantine():
    out = train(ARGS + ["--steps", "10", "--lr", "1e-3",
                        "--inject", "sigma-blowup@6"])
    rec = {h["step"]: h for h in out["history"]}
    assert rec[6]["theta_clamped"] and rec[6]["subspace_update"]
    assert not any(h["theta_clamped"] for h in out["history"]
                   if h["step"] != 6)
    assert not out["quarantined_steps"] and np.isfinite(out["final_loss"])


def test_corrupt_batch_is_skip_marked_and_struck():
    out = train(ARGS + ["--steps", "8", "--lr", "1e-3",
                        "--inject", "corrupt-batch@5"])
    assert out["skipped_batches"] == [5] and out["rollbacks"] == 0
    assert out["sentinel_events"] == [{
        "step": 5, "reason": "unusable batch (skip-marked)",
        "action": "skip"}]
    assert np.isfinite(out["final_loss"])


def test_ckpt_io_error_is_absorbed_and_slow_host_is_flagged(tmp_path):
    out = train(ARGS + ["--steps", "10", "--lr", "1e-3",
                        "--checkpoint-every", "4", "--checkpoint-dir",
                        str(tmp_path), "--stall-s", "0.3",
                        "--inject", "ckpt-io-error@4,slow-host@8"])
    assert (tmp_path / "step_0000000004" / "data.bin").exists()
    assert CheckpointManager(tmp_path).known_good_steps() == [4, 8, 9]
    assert [s for s, _ in out["stragglers"]] == [8]
    assert np.isfinite(out["final_loss"])


def test_fail_and_restart_reproduce_the_uninterrupted_run(ref, tmp_path):
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "5"]
    with pytest.raises(RuntimeError, match="failure-injection"):
        train(ARGS + SHORT + ck + ["--fail-at-step", "9"])
    resumed = train(ARGS + SHORT + ck)
    assert resumed["start_step"] == 6 and resumed["warm_start_s"] is None
    got, want = _losses(resumed), _losses(ref)
    assert sorted(got) == list(range(6, 14))
    for s in got:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-4, err_msg=s)


def test_preempt_leaves_a_marker_and_auto_resumes(ref, tmp_path, capsys):
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "50"]
    handler = signal.getsignal(signal.SIGTERM)
    out = train(ARGS + SHORT + ck + ["--inject", "preempt@6"])
    assert signal.getsignal(signal.SIGTERM) is handler    # restored
    assert out["preempted"] and [h["step"] for h in out["history"]] == \
        list(range(7))
    mgr = CheckpointManager(tmp_path)
    assert mgr.known_good_steps() == [6]
    assert (tmp_path / CheckpointManager.RESUME_MARKER).exists()
    resumed = train(ARGS + SHORT + ck)
    assert "resume marker found (step 6" in capsys.readouterr().out
    assert not (tmp_path / CheckpointManager.RESUME_MARKER).exists()
    assert resumed["start_step"] == 7 and not resumed["preempted"]
    got, want = _losses(resumed), _losses(ref)
    for s in got:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-4, err_msg=s)


def test_cli_resumes_a_jax_checkpoint_elastically(tmp_path):
    """The JAX package's smoke-llama state at rank 8, saved by its own
    manager, resumes the port's CLI at rank 4 (the transpose truncates
    each basis) from step 5 on, with no warm start."""
    cfg = jax_get_config("llama-60m", smoke=True)
    opt = jax_get_optimizer("subtrack", rank=8)
    shapes = jax.eval_shape(lambda key: (lambda p: JTrainState(
        params=p, opt=opt.init(p)))(jax_build_model(cfg).init(key)),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # numpy values in the JAX state's shapes and dtypes (nothing compiled):
    # params N(0, 0.02), the init's S = I[:, :r], zero moments, step 5
    params = jax.tree.map(lambda x: (0.02 * rng.standard_normal(
        x.shape)).astype(x.dtype), shapes.params)
    def zeros(x):
        return np.zeros(x.shape, x.dtype)

    def node(st):
        if not isinstance(st, JMatrixOptState):
            return jax.tree.map(zeros, st)
        eye = np.eye(*st.S.shape[-2:], dtype=np.float32)
        return JMatrixOptState(S=np.broadcast_to(eye, st.S.shape).copy(),
                               M=zeros(st.M), V=zeros(st.V),
                               lam_prev=zeros(st.lam_prev))

    inner = jax.tree.map(node, shapes.opt.inner,
                         is_leaf=lambda x: isinstance(x, JMatrixOptState))
    state = JTrainState(params=params, opt=shapes.opt._replace(
        step=np.int32(5), n_updates=np.int32(2), inner=inner))
    JCheckpointManager(tmp_path).save(
        4, state, blocking=True, extra_meta=jxp.state_program_records(
            state, jax_descriptors(params, opt)))
    out = train(ARGS + ["--rank", "4", "--steps", "8", "--lr", "1e-3",
                        "--checkpoint-dir", str(tmp_path)])
    assert out["start_step"] == 5 and out["warm_start_s"] is None
    assert [h["step"] for h in out["history"]] == [5, 6, 7]
    assert out["state"].opt.step == 8
    assert out["state"].opt.inner["layers"]["attn"]["wq"].S.shape[-1] == 4
    assert np.isfinite(out["final_loss"])
