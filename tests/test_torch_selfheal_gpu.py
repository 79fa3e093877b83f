"""The self-healing serve on the card: a supervised worker SIGKILLed
mid-request is restarted and replays its journal through the hand kernels.

Needs a CUDA device and ``nvcc``: the test is marked ``gpu`` and skips
without a card. Run on the card with
``python -m pytest -q --noconftest -m gpu tests/test_torch_selfheal_gpu.py``.
This file imports no JAX and no h5py.

The world is chip_smoke.py's at P = V = 4096 (cameras of 64 x 32, a 64 x 64
grid), where ``plan_sweep`` gives ``one_read`` at B = 2. Part (a) of
chip_smoke's phase ``selfheal`` (:func:`chip_smoke.supervised_restart`):
``serve --supervised --lanes 2`` on the card, its worker SIGKILLed inside a
4-frame request's dispatched journal window; the supervisor restarts it,
the restart replays the journal: one ``completed`` marker, the rows byte
for byte the CLI's ``--no_guess --batch_frames 2`` over the same frames,
``engine_restarts_total{reason="signal:SIGKILL"}`` 1, exit 4 on SIGTERM,
and the restarted worker's served frames on ``one_read``.
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_supervised_sigkill_and_replay_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=64, ny=64, cam=(64, 32), n_frames=8)
    rec = cs.supervised_restart(world, str(tmp_path), device="cuda")
    assert rec["worker_command"] == ["-m", "sartsolver_tpu_torch.cli", "serve"]
    assert rec["exit"] == 4 and rec["completed_markers"] == 1 and rec["restarts_sigkill"] == 1
    assert rec["outcome"]["status"] == "completed" and rec["outcome"]["frames"] == 4
    _first, restarted = rec["launches_by_incarnation"]
    assert restarted["kernel=fused_sweep,plan=one_read"] > 0
    assert rec["kill_to_ready_parts"]["cuda_init_s"] > 0
    assert rec["kill_to_ready_parts"]["warm_up_s"] > 0
