"""The port's training driver and fault-tolerant loop on the CPU, port only:
``repro_torch.launch.train.main`` mirrors the reference's driver tests
(tests/test_train_driver.py, which fail on this tree under jax 0.9.0's
sharding rules), and ``TrainLoopRunner`` the reference's fault-loop tests
(tests/test_substrates.py): retries, restarts from a checkpoint, the
straggler deadline, and the port's torn-state escalation.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import tree as t_tree
from repro_torch.checkpoint import manager as ckpt
from repro_torch.launch import train as train_mod
from repro_torch.runtime import (
    FaultConfig,
    StepTimeout,
    TrainLoopRunner,
    TransientDeviceError,
    elastic_remesh,
)
from repro_torch.runtime.fault import TornState


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """SMOKE shapes gain nothing from more intra-op threads, and the tier-1
    run shares the machine's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _main(*argv, injector=None):
    return train_mod.main([*argv, "--device", "cpu", "--log-every", "100"],
                          failure_injector=injector)


def test_train_driver_end_to_end(tmp_path):
    state, hist = _main(
        "--arch", "granite-moe-1b-a400m", "--smoke", "--steps", "12",
        "--batch", "4", "--seq", "64", "--lr", "5e-3",
        "--ckpt-dir", str(tmp_path / "ckpt"), "--save-every", "6")
    losses = hist["loss"]
    assert len(losses) == 12
    assert all(np.isfinite(losses))
    # synthetic data has structure; a dozen steps should already help
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert os.path.isdir(str(tmp_path / "ckpt" / "step_00000012"))
    assert [r["step"] for r in hist["steps"]] == list(range(1, 13))
    assert all(r["grad_norm"] > 0 and r["lr"] >= 0 for r in hist["steps"])


def test_train_driver_resume(tmp_path):
    args = ("--arch", "mamba2-2.7b", "--smoke", "--batch", "2", "--seq",
            "32", "--save-every", "3")
    ckpt_dir = str(tmp_path / "ckpt")
    first, _ = _main(*args, "--steps", "6", "--ckpt-dir", ckpt_dir)
    restored, extra = ckpt.restore(ckpt_dir, 6, first)
    assert extra == {"next_step": 6}
    for (path, a), (_, b) in zip(t_tree.flatten_with_path(first),
                                 t_tree.flatten_with_path(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    # resume to 9 steps: the runner restores step 6 and runs 3 more
    state, hist = _main(*args, "--steps", "9", "--ckpt-dir", ckpt_dir)
    assert len(hist["loss"]) == 3  # only the new steps
    assert int(state["step"]) == 9


def test_train_driver_default_ckpt_dir_is_per_run(tmp_path, monkeypatch):
    """Without --ckpt-dir each run checkpoints into a temporary directory of
    its own (under TMPDIR), removed when it ends: a second run trains all
    its steps again and does not resume from the first's checkpoint."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = ("--arch", "musicgen-medium", "--smoke", "--steps", "2",
            "--batch", "2", "--seq", "16", "--save-every", "1")
    for _ in range(2):
        state, hist = _main(*args)
        assert len(hist["loss"]) == 2 and int(state["step"]) == 2
        assert all(np.isfinite(hist["loss"]))
    assert os.listdir(tmp_path) == []


def test_train_driver_retries_a_transient_failure(tmp_path):
    failed = []

    def injector(step):
        if step == 2 and not failed:
            failed.append(step)
            raise TransientDeviceError("injected device failure")

    state, hist = _main(
        "--arch", "musicgen-medium", "--smoke", "--steps", "4", "--batch",
        "2", "--seq", "16", "--ckpt-dir", str(tmp_path), "--save-every", "2",
        injector=injector)
    assert failed == [2]
    assert hist["restarts"] == 0
    assert len(hist["loss"]) == 4 and int(state["step"]) == 4


def test_train_driver_restarts_on_a_step_timeout(tmp_path):
    """A straggler's StepTimeout is not retried in place: ``main``'s loop
    restarts from the newest checkpoint (step 4) and finishes."""
    timed_out = []

    def injector(step):
        if step == 5 and not timed_out:
            timed_out.append(step)
            raise StepTimeout("injected straggler")

    state, hist = _main(
        "--arch", "musicgen-medium", "--smoke", "--steps", "6", "--batch",
        "2", "--seq", "16", "--ckpt-dir", str(tmp_path), "--save-every", "4",
        injector=injector)
    assert timed_out == [5]
    assert hist["restarts"] == 1
    # steps 0..4 before the timeout, then 4 and 5 again from the checkpoint
    assert len(hist["loss"]) == 7 and hist["loss"][4] == hist["loss"][5]
    assert int(state["step"]) == 6


def test_train_driver_without_device_raises_where_there_is_no_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: main would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", "musicgen-medium", "--smoke", "--steps",
                        "1", "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------


def _counter_runner(tmp_path, injector=None, deadline=None, step_fn=None,
                    max_restarts=5, async_save=False):
    def count(state, batch):
        return {"x": state["x"] + batch["inc"]}, {"loss": state["x"][0]}

    return TrainLoopRunner(
        step_fn=step_fn or count,
        init_state_fn=lambda: {"x": torch.zeros(2)},
        batch_fn=lambda step: {"inc": torch.ones(2)},
        cfg=FaultConfig(ckpt_dir=str(tmp_path), save_every=5,
                        max_step_retries=1, step_deadline_s=deadline,
                        max_restarts=max_restarts, async_save=async_save),
        failure_injector=injector,
    )


@pytest.mark.parametrize("async_save", [False, True])
def test_fault_loop_clean_run(tmp_path, async_save):
    state, hist = _counter_runner(tmp_path, async_save=async_save).run(12)
    assert float(state["x"][0]) == 12.0
    assert hist["restarts"] == 0
    assert ckpt.latest_step(str(tmp_path)) == 12
    assert hist["loss"] == [float(i) for i in range(12)]


def test_fault_loop_restart_from_checkpoint(tmp_path):
    boom = {"count": 0}

    def injector(step):
        if step == 8 and boom["count"] < 2:
            boom["count"] += 1
            raise RuntimeError("persistent failure")

    state, hist = _counter_runner(tmp_path, injector=injector).run(12)
    assert float(state["x"][0]) == 12.0
    assert hist["restarts"] == 1  # exhausted retries once -> restarted
    # steps 5..7 ran twice: before the failure and again from step 5
    assert hist["loss"][5:8] == hist["loss"][8:11] == [5.0, 6.0, 7.0]


def test_step_timeout_escalates_to_a_restart(tmp_path):
    import time

    slow = {"done": False}

    def step_fn(state, batch):
        if int(state["x"][0]) == 7 and not slow["done"]:
            slow["done"] = True
            time.sleep(0.3)
        return {"x": state["x"] + batch["inc"]}, {"loss": state["x"][0]}

    runner = _counter_runner(tmp_path, deadline=0.2, step_fn=step_fn)
    state, hist = runner.run(12)
    assert float(state["x"][0]) == 12.0
    assert hist["restarts"] == 1  # not retried in place: restarted at 5


def test_straggler_deadline_raises_without_restarts(tmp_path):
    import time

    def step_fn(state, batch):
        time.sleep(0.3)
        return state, {"loss": 0.0}

    runner = _counter_runner(tmp_path, deadline=0.05, step_fn=step_fn,
                             max_restarts=0)
    with pytest.raises(StepTimeout):
        runner.run(2)


def test_a_torn_state_restarts_from_the_checkpoint(tmp_path):
    torn = {"done": False}

    def step_fn(state, batch):
        state["x"].add_(batch["inc"])  # in place, as the optimizer does
        if int(state["x"][0]) == 8 and not torn["done"]:
            torn["done"] = True
            raise TornState("injected failure inside the update")
        return state, {"loss": state["x"][0]}

    state, hist = _counter_runner(tmp_path, step_fn=step_fn).run(12)
    assert float(state["x"][0]) == 12.0  # a retry in place would give 13
    assert hist["restarts"] == 1


def test_async_save_failure_surfaces_in_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncSaver()
    saver.save(str(blocker / "ckpt"), 1, {"a": torch.ones(2)})
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()  # reported once


def test_elastic_remesh():
    mesh = elastic_remesh()
    assert "data" in mesh.axis_names and "model" in mesh.axis_names
    assert mesh.shape["data"] * mesh.shape["model"] == 1
