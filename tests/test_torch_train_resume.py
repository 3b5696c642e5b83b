"""tests/test_cli.py's training command-line tests on the port (CPU, fp32,
the TINY config of ``tests/_torch_cli_common.py``; no JAX run): overfit
(``:97``), the fused AdamW then ``-continue`` from its ``.ckpt`` (``:111``),
train then ``val`` from the ``.ckpt`` (``:139``), ``-continue`` from the
native directory (``:173``) and from a reference ``.ckpt`` (``:234``),
length-bucketed accumulation (``:255``), ``-auto_resume`` (``:275``,
``:295``), the eval CLIs reading the native directory, the profiler window,
and the kill -9 drill (``:336``) in a subprocess with ``device="cpu"``."""

import os
import signal
import subprocess
import sys
import time

import pytest

from tests import _torch_cli_common as cc
from unimm_torch import checkpoint as tck
from unimm_torch.cli import options as t_options
from unimm_torch.cli import train as t_train
from unimm_torch.cli import val as t_val
from unimm_torch.cli import val_lm as t_val_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["-overfit", "-num_epochs", "1", "-batch_size", "12",
         "-sequences_per_image", "6", "-num_negative_samples", "1"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return cc.make_world(tmp_path_factory.mktemp("torch_train_resume"))


def _train(world, extra, name):
    return cc.run(world, t_train.main, extra, name, "torch")


@pytest.fixture(scope="module")
def overfit(world):
    return _train(world, SMALL + ["-eval_every_epochs", "1"], "overfit")


def test_train_cli_overfit(overfit):
    state, ckpt_dir = overfit
    assert state["step"] > 0
    files = os.listdir(ckpt_dir)
    assert any(f.endswith(".ckpt") for f in files) and "native" in files


def test_train_cli_fused_adamw(world):
    state, ckpt_dir = _train(world, SMALL + ["-eval_every_epochs", "1",
                                             "-fused_adamw", "1"], "fused")
    assert state["step"] > 0 and state["opt"].fused
    state2, _ = _train(world, SMALL + [
        "-eval_every_epochs", "1", "-fused_adamw", "1", "-continue",
        "-start_path", os.path.join(ckpt_dir, cc.ckpts(ckpt_dir)[0])],
        "fused2")
    assert state2["step"] > state["step"]
    assert state2["opt"].count == state["opt"].count + 1


def test_train_then_val_from_checkpoint(world, overfit):
    _, ckpt_dir = overfit
    cwd = os.getcwd()
    os.chdir(world["root"])
    try:
        metrics = t_val.main(cc.argv(world, [
            "-model_paths", os.path.join(ckpt_dir, cc.ckpts(ckpt_dir)[0]),
            "-save_name", "val_ens"]), device="cpu")
        # the eval CLIs take the native directory too
        native = t_val_lm.main(cc.argv(world, [
            "-val_dis", "0", "-start_path", os.path.join(ckpt_dir, "native"),
            "-save_name", "val_native"]), device="cpu")
        from_ckpt = t_val_lm.main(cc.argv(world, [
            "-val_dis", "0", "-start_path",
            os.path.join(ckpt_dir, cc.ckpts(ckpt_dir)[0]),
            "-save_name", "val_ckpt"]), device="cpu")
    finally:
        os.chdir(cwd)
    assert "ndcg" in metrics
    assert native == from_ckpt


def test_train_continue_resumes(world):
    args = SMALL + ["-eval_every_epochs", "99"]
    state1, ckpt_dir = _train(world, args, "resume")
    assert state1["step"] > 0
    state2, _ = _train(world, args + [
        "-continue", "-start_path", os.path.join(ckpt_dir, "native")],
        "resume")
    assert state2["step"] == 2 * state1["step"]


def test_train_continue_from_reference_ckpt(world, overfit):
    _, ckpt_dir = overfit
    name = cc.ckpts(ckpt_dir)[0]
    saved_iter = int(name.rsplit("_", 1)[1].split(".")[0])
    state, _ = _train(world, SMALL + [
        "-eval_every_epochs", "5", "-continue",
        "-start_path", os.path.join(ckpt_dir, name)], "cont_ref")
    assert state["step"] > saved_iter
    assert tck.extract_adam_moments(state["opt"])[2] > 0


def test_train_cli_length_bucketed_accumulation(world):
    state, ckpt_dir = _train(world, [
        "-num_epochs", "2", "-batch_size", "12", "-sequences_per_image", "6",
        "-num_negative_samples", "1", "-batch_multiply", "2",
        "-length_buckets", "1", "-eval_every_epochs", "100",
        "-save_every_epochs", "2"], "lb")
    # 2 epochs x 3 loader batches: a buffered pair and a remainder flush
    assert state["step"] == 6
    assert any(f.endswith(".ckpt") for f in os.listdir(ckpt_dir))


def test_train_auto_resume(world):
    args = SMALL + ["-eval_every_epochs", "99", "-auto_resume"]
    state1, _ = _train(world, args, "autoresume")
    assert state1["step"] > 0
    state2, _ = _train(world, args, "autoresume")
    assert state2["step"] == 2 * state1["step"]


def test_auto_resume_requires_save_name():
    with pytest.raises(SystemExit):
        t_options.read_command_line(["-auto_resume"])


def test_profiler_window_writes_a_trace(world, tmp_path):
    """-profile_dir traces steps 10-15 (torch.profiler); without it the
    profiler does nothing."""
    from unimm_torch.cli.common import StepProfiler
    prof = StepProfiler(str(tmp_path / "trace"), start=1, stop=2)
    prof.step(1)
    sum(range(1000))
    prof.step(2)
    prof.close()
    assert os.listdir(tmp_path / "trace") == ["trace_1_2.json"]
    off = StepProfiler("")
    for i in range(20):
        off.step(i)
    off.close()


# the child writes its first .ckpt, then waits, so the kill lands inside the
# run whatever the machine's speed
_CHILD = """
import sys, time
from unimm_torch import checkpoint as C
from unimm_torch.cli import train
real = C.save_reference_ckpt
def save_then_wait(*a, **kw):
    real(*a, **kw)
    if {first}:
        time.sleep(120)
C.save_reference_ckpt = save_then_wait
s = train.main({argv!r}, device="cpu")
print("FINAL_STEP", s["step"], flush=True)
"""


def test_train_kill9_then_auto_resume(tmp_path):
    """SIGKILL a training run after its first epoch's checkpoint lands,
    relaunch the identical command with -auto_resume: it restores the
    latest native state and finishes the original 3-epoch budget."""
    world = cc.make_world(tmp_path)
    argv = cc.argv(world, [
        "-num_epochs", "3", "-batch_size", "12", "-sequences_per_image", "6",
        "-num_negative_samples", "1", "-eval_every_epochs", "99",
        "-save_name", "kill9", "-auto_resume"])
    ckpt_dir = os.path.join(world["root"], "ckpt", "kill9")
    env = dict(os.environ, PYTHONPATH=REPO)
    log1 = os.path.join(world["root"], "run1.log")
    with open(log1, "wb") as lf:
        p1 = subprocess.Popen(
            [sys.executable, "-c", _CHILD.format(first=True, argv=argv)],
            cwd=world["root"], env=env, stdout=lf, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 600     # a loaded machine's start
            while time.time() < deadline:
                # the .ckpt is written after the native save
                if os.path.isdir(ckpt_dir) and cc.ckpts(ckpt_dir):
                    break
                if p1.poll() is not None:
                    raise AssertionError(
                        f"run 1 exited early:\n{open(log1).read()[-3000:]}")
                time.sleep(0.2)
            else:
                raise AssertionError(f"run 1 never saved:\n"
                                     f"{open(log1).read()[-3000:]}")
        finally:
            if p1.poll() is None:
                p1.send_signal(signal.SIGKILL)
            p1.wait(timeout=60)
    assert p1.returncode == -signal.SIGKILL
    out = subprocess.run(
        [sys.executable, "-c", _CHILD.format(first=False, argv=argv)],
        cwd=world["root"], env=env, timeout=600, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT).stdout.decode()
    assert "restored native checkpoint at step " in out, out[-3000:]
    restored = int(out.split("restored native checkpoint at step ")[1]
                   .split()[0])
    final = int(out.split("FINAL_STEP ")[1].split()[0])
    # 3 steps an epoch: restored at epoch 1's end, the budget is 9 steps
    assert (restored, final) == (3, 9), out[-3000:]
    assert sorted(os.listdir(os.path.join(ckpt_dir, "native"))) == [
        "step_3", "step_6", "step_9"]
