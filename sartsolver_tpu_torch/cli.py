"""``sartsolve`` for one CUDA device (or the CPU), in PyTorch.

Counterpart of ``sartsolver_tpu/cli.py``'s one-shot solve
(main.cpp:25-151): parse and validate the reference flags, classify and
cross-check the input files, build the composite measurement stream, read
the RTM whole on the host and upload it once, then solve the frames in order
— each warm-started from the previous frame's solution unless
``--no_guess`` — and write the solution file and the voxel map.

The warm start stays on the device: the previous solution and its loop-exit
``fitted == H @ f`` are rescaled by ``norm_prev / norm_new`` and seed the
next frame, which then skips its setup forward projection.

``--device cuda`` (the default) runs the fp32 profile on the card through the
fused-sweep kernel; ``--device cpu`` runs the same profile on the CPU with
the kernel's plain version. ``--use_cpu`` is the fp64 parity profile on the
CPU, as in the JAX package.

Usage: ``python -m sartsolver_tpu_torch.cli -o solution.h5 RTM... IMAGE...``
"""

from __future__ import annotations

import argparse
import sys
import time as _time
from typing import List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sartsolve",
        description="Impurity flux reconstruction for ITER: emissivity "
                    "(PyTorch, one device).",
        epilog="exit codes: 0 success; 1 input/flag error.",
    )
    p.add_argument("-o", "--output_file", default="solution.h5",
                   help="Filename to save the solution.")
    p.add_argument("-t", "--time_range", default="",
                   help="Time intervals in s to process in a form: "
                        "start:stop:(step):(synch_threshold), e.g. "
                        "'20.5:40.1, 45.2:51:1.5:0.05'. The step and the "
                        "synchronization threshold are optional.")
    p.add_argument("-w", "--wavelength_threshold", type=float, default=50.0,
                   help="An RTM is considered valid if its wavelength is within "
                        "this threshold of the image wavelength (in nm).")
    p.add_argument("-d", "--ray_density_threshold", type=float, default=1.0e-6,
                   help="Voxels with ray density lesser than this threshold are ignored.")
    p.add_argument("-r", "--ray_length_threshold", type=float, default=1.0e-6,
                   help="Pixels with ray length lesser than this threshold are ignored.")
    p.add_argument("-m", "--max_iterations", type=int, default=2000,
                   help="Maximum number of SART iterations.")
    p.add_argument("-c", "--conv_tolerance", type=float, default=1.0e-5,
                   help="SART convolution relative tolerance.")
    p.add_argument("-l", "--laplacian_file", default="",
                   help="File with laplacian regularization matrix.")
    p.add_argument("-b", "--beta_laplace", type=float, default=2.0e-2,
                   help="Weight of the regularization factor.")
    p.add_argument("-R", "--relaxation", type=float, default=1.0,
                   help="Relaxation parameter.")
    p.add_argument("-n", "--raytransfer_name", default="with_reflections",
                   help="Ray transfer matrix dataset name.")
    p.add_argument("-L", "--logarithmic", action="store_true",
                   help="Use logarithmic SART solver.")
    p.add_argument("--max_cached_frames", type=int, default=100,
                   help="Maximum number of cached image frames.")
    p.add_argument("--max_cached_solutions", type=int, default=100,
                   help="Maximum number of cached solutions.")
    p.add_argument("--no_guess", action="store_true",
                   help="Do not use solution found on previous time moment as "
                        "initial guess for the next one.")
    p.add_argument("--use_cpu", action="store_true",
                   help="Perform all calculations on CPUs (fp64 parity profile).")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device of the fp32 profile (default cuda). Without a "
                        "CUDA device the run stops; --device cpu runs the "
                        "same profile on the CPU.")
    p.add_argument("input_files", nargs="*",
                   help="List of ray transfer matrix and camera image hdf5 files.")
    return p


def _validate(args) -> None:
    """Range validation mirroring arguments.cpp:184-236."""
    def fail(msg: str) -> None:
        print(msg, file=sys.stderr)
        raise SystemExit(1)

    if args.ray_density_threshold < 0:
        fail(f"Argument ray_density_threshold must be >= 0, {args.ray_density_threshold} given.")
    if args.ray_length_threshold < 0:
        fail(f"Argument ray_length_threshold must be >= 0, {args.ray_length_threshold} given.")
    if args.max_iterations < 1:
        fail(f"Argument max_iterations must be >= 1, {args.max_iterations} given.")
    if args.max_iterations > 2**24:
        fail(f"Argument max_iterations must be <= {2**24}, "
             f"{args.max_iterations} given.")
    if args.conv_tolerance <= 0:
        fail(f"Argument conv_tolerance must be > 0, {args.conv_tolerance} given.")
    if not (0 < args.relaxation <= 1.0):
        fail(f"Argument relaxation must be within (0, 1] interval, {args.relaxation} given.")
    if args.beta_laplace < 0:
        fail("Argument beta_laplace must be positive.")
    if args.max_cached_frames <= 0:
        fail("Argument max_cached_frames must be positive.")
    if args.max_cached_solutions <= 0:
        fail("Argument max_cached_solutions must be positive.")
    if len(args.input_files) < 2:
        fail("At least two input file, one with RTM and one with image, are "
             f"required, {len(args.input_files)} given.")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as err:
        # argparse exits 2 on a malformed flag; the reference's contract is 1
        raise SystemExit(1 if err.code else 0) from None
    _validate(args)

    import torch

    from sartsolver_tpu_torch.config import SartInputError, SolverOptions, parse_time_intervals
    from sartsolver_tpu_torch.device import resolve_device
    from sartsolver_tpu_torch.io import hdf5files as hf
    from sartsolver_tpu_torch.io.image import CompositeImage
    from sartsolver_tpu_torch.io.laplacian_io import read_laplacian
    from sartsolver_tpu_torch.io.raytransfer import read_rtm_block
    from sartsolver_tpu_torch.io.solution import SolutionWriter
    from sartsolver_tpu_torch.io.voxelgrid import make_voxel_grid
    from sartsolver_tpu_torch.models.sart import (
        resolve_fused, make_problem, prepare_measurement,
        solve_normalized_batch, torch_dtype,
    )
    from sartsolver_tpu_torch.ops.laplacian import make_laplacian

    try:
        device = resolve_device("cpu" if args.use_cpu else args.device)
    except RuntimeError as err:
        print(err, file=sys.stderr)
        return 1

    try:
        time_intervals = parse_time_intervals(args.time_range)

        # ---- pre-flight validation gate (main.cpp:30-59) -----------------
        matrix_files, image_files = hf.categorize_input_files(args.input_files)
        rtm_name = args.raytransfer_name
        hf.check_group_attribute_consistency(matrix_files, f"rtm/{rtm_name}", ["wavelength"])
        hf.check_group_attribute_consistency(matrix_files, "rtm/voxel_map", ["nx", "ny", "nz"])
        sorted_matrix_files = hf.sort_rtm_files(matrix_files)
        hf.check_rtm_frame_consistency(sorted_matrix_files)
        hf.check_rtm_voxel_consistency(sorted_matrix_files)
        hf.check_group_attribute_consistency(image_files, "image", ["wavelength"])
        sorted_image_files = hf.sort_image_files(image_files)
        camera_names = list(sorted_image_files)
        hf.check_rtm_image_consistency(
            sorted_matrix_files, sorted_image_files, rtm_name, args.wavelength_threshold
        )
        npixel, nvoxel = hf.get_total_rtm_size(sorted_matrix_files)
        rtm_frame_masks = hf.read_rtm_frame_masks(sorted_matrix_files)

        common = dict(
            logarithmic=args.logarithmic,
            ray_density_threshold=args.ray_density_threshold,
            ray_length_threshold=args.ray_length_threshold,
            conv_tolerance=args.conv_tolerance,
            beta_laplace=args.beta_laplace,
            relaxation=args.relaxation,
            max_iterations=args.max_iterations,
        )
        opts = (SolverOptions.cpu_parity(**common) if args.use_cpu
                else SolverOptions(**common))
        dtype = torch_dtype(opts.dtype)

        lap = None
        if args.laplacian_file:
            rows, cols, vals = read_laplacian(args.laplacian_file, nvoxel)
            lap = make_laplacian(rows, cols, vals, nvoxel=nvoxel, dtype=dtype,
                                 device=device)

        composite_image = CompositeImage(
            sorted_image_files, rtm_frame_masks, time_intervals, npixel,
            max_cache_size=args.max_cached_frames,
        )
        # the whole matrix on the host, uploaded once
        rtm = read_rtm_block(sorted_matrix_files, rtm_name, npixel, nvoxel,
                             dtype=np.dtype(opts.dtype))
        problem = make_problem(rtm, lap, opts=opts, device=device)
        del rtm
        grid = make_voxel_grid(next(iter(sorted_matrix_files.values())), "rtm/voxel_map")
        sweep = "fused" if resolve_fused(opts) else "two-matmul"
        print(f"solver: device={device} compute={opts.dtype} sweep={sweep} "
              f"rtm=[{npixel}, {nvoxel}]")

        # ---- frame loop (main.cpp:131-140) -------------------------------
        warm = None  # (solution, fitted, norm) of the previous frame
        with SolutionWriter(args.output_file, camera_names, nvoxel,
                            max_cache_size=args.max_cached_solutions) as writer:
            for idx in range(len(composite_image)):
                frame = composite_image.frame(idx)
                ftime = composite_image.frame_time(idx)
                cam_times = composite_image.camera_frame_time(idx)
                t0 = _time.perf_counter()
                g64, msq, norm = prepare_measurement(frame, opts)
                g = torch.as_tensor(g64[None, :], device=device).to(dtype)
                msq_t = torch.tensor([msq], dtype=dtype, device=device)
                if warm is None:
                    res, fitted = solve_normalized_batch(
                        problem, g, msq_t,
                        torch.zeros((1, nvoxel), dtype=dtype, device=device),
                        opts=opts, use_guess=True, return_fitted=True,
                        device=device,
                    )
                else:
                    sol_prev, fit_prev, norm_prev = warm
                    # fp64 norm ratio rounded to the compute dtype, as the
                    # JAX driver's device-side warm rescale does
                    scale = torch.tensor(norm_prev / norm, dtype=dtype, device=device)
                    res, fitted = solve_normalized_batch(
                        problem, g, msq_t, sol_prev * scale, opts=opts,
                        use_guess=False, fitted0=fit_prev * scale,
                        return_fitted=True, device=device,
                    )
                if not args.no_guess:
                    warm = (res.solution, fitted, norm)
                status = int(res.status[0])
                iterations = int(res.iterations[0])
                solution = res.solution[0].double().cpu().numpy() * norm
                writer.add(solution, status, ftime, cam_times, iterations=iterations)
                elapsed_ms = (_time.perf_counter() - t0) * 1e3
                print(f"Processed in: {elapsed_ms} ms")

        grid.write_hdf5(args.output_file, "voxel_map")
    except KeyError as err:
        # a missing dataset or attribute raises KeyError
        print(f"Missing dataset or attribute in input files: {err}", file=sys.stderr)
        return 1
    except (SartInputError, OSError) as err:
        # only input problems get the reference's message + exit(1); any
        # other exception is a bug and tracebacks
        print(err, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
