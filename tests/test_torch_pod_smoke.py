"""chip_smoke.py's ``pod`` phase rehearsed on the CPU at a small size (a
file of its own, so ``--dist loadfile`` runs it beside the other pod
drills): the solo run, the campaign's reference pass as the two fake-pod
workers, ``chaos --pod 2 --seeds 0,3`` and the 2x1 grid's resume and kill
(the launch counts are the card's)."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_pod_phase_at_small_size(tmp_path):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    world = cs.write_world(str(tmp_path), nx=16, ny=16, cam=(8, 4), n_frames=cs.POD_FRAMES)
    rec = cs.pod_phase(world, str(tmp_path), device="cpu")
    solo, pair = rec["solo"], rec["pair"]
    assert solo["frames"] == cs.POD_FRAMES and solo["loop_steps"] > 0
    assert [w["frames"] for w in pair["workers"]] == [cs.POD_FRAMES] * 2
    assert [w["loop_steps"] for w in pair["workers"]] == [solo["loop_steps"]] * 2
    assert all(w["status"] == solo["status"] for w in pair["workers"])
    assert pair["stride_barriers"] > 0 and len(pair["ckpt_files"]) == 2
    assert len(pair["ms_per_frame_pod_over_solo"]) == 2 and pair["seconds"] > 0
    chaos = rec["chaos"]
    assert chaos["verdict"] == "ok" and [v["seed"] for v in chaos["passes"]] == [0, 3]
    assert [v["window"].split("#")[0] for v in chaos["passes"]] == ["ckpt", "stride"]
    runs = rec["grid"]["runs"]
    assert runs["half"]["frames"] + runs["resumed"]["frames"] == cs.POD_FRAMES
    assert runs["resumed"]["broadcast_s"] > 0 and runs["killed"]["exit"] == 3
    assert rec["grid"]["status"] == solo["status"]
    assert not os.path.exists(tmp_path / "pod")
