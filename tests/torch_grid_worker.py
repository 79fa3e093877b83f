"""One rank of a grid of ranks for the grid tests (tests/test_torch_grid_mp.py).

Run as ``python tests/torch_grid_worker.py JOBS OUT`` with the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).
``JOBS`` is a pickled list of dicts, each a solve on a grid of the world's
size: ``name``, ``grid`` ``(P, V)``, ``H`` [P, V], ``G`` [B, P] frames,
``lap`` (rows, cols, vals) or None, ``opts`` (SolverOptions keywords),
``cpu_parity`` (the fp64 profile), ``mode`` (``batch``, ``chain`` or
``local``: solve_batch on this rank's rows only). Rank 0 writes
``OUT/<name>.npz``: the solutions, statuses, iterations, convergence and
the collectives' count; every rank writes the rank's own solution bytes as
``OUT/<name>.r<rank>.npy``. A job with ``cli`` (an argv, ``--multihost``
among it) runs the CLI's main on every rank instead, in the process group
this worker started, and writes each rank's exit code, stdout and stderr
to ``OUT/<name>.r<rank>.json``.
"""

import os
import pickle
import sys

import numpy as np


def dist_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def main(jobs_path: str, out_dir: str) -> int:
    import torch

    from sartsolver_tpu_torch.config import SolverOptions
    from sartsolver_tpu_torch.ops.laplacian import make_laplacian
    from sartsolver_tpu_torch.parallel import comm, multihost
    from sartsolver_tpu_torch.parallel.mesh import make_grid
    from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

    torch.set_num_threads(1)
    multihost.initialize("cpu")
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    grids = {}
    for job in jobs:
        if job.get("cli") is not None:  # the CLI's main on every rank
            import contextlib
            import io
            import json

            from sartsolver_tpu_torch import cli

            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(job["cli"])
            with open(os.path.join(out_dir, f"{job['name']}.r{dist_rank()}.json"), "w") as f:
                json.dump({"rc": rc, "out": out.getvalue(), "err": err.getvalue()}, f)
            continue
        shape = tuple(job["grid"])
        if shape not in grids:  # every rank makes the same groups, in order
            grids[shape] = make_grid(*shape)
        grid = grids[shape]
        opts = (SolverOptions.cpu_parity(**job["opts"]) if job["cpu_parity"]
                else SolverOptions(**job["opts"]))
        H = np.asarray(job["H"], np.float64 if job["cpu_parity"] else np.float32)
        lap = None
        if job["lap"] is not None:
            lap = make_laplacian(*job["lap"], nvoxel=H.shape[1],
                                 dtype=torch.float64 if job["cpu_parity"] else torch.float32)
        solver = DistributedSARTSolver(H, lap, opts=opts, device="cpu", grid=grid)
        comm.reset_stats()
        G = np.asarray(job["G"], np.float64)
        if job["mode"] == "chain":
            res = solver.solve_chain(G)
        elif job["mode"] == "local":
            off, count = solver.local_pixel_range()
            res = solver.solve_batch(G[:, off:off + count], local=True)
        else:
            res = solver.solve_batch(G)
        sol = res.fetch_solutions()
        np.save(os.path.join(out_dir, f"{job['name']}.r{grid.rank}.npy"),
                res.solution_norm.numpy())
        if grid.rank == 0:
            np.savez(os.path.join(out_dir, f"{job['name']}.npz"), solution=sol,
                     status=res.status, iterations=res.iterations,
                     convergence=res.convergence, collectives=comm.stats["calls"])
    comm.shutdown()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(*sys.argv[1:3]))
