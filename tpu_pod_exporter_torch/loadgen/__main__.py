"""CLI load generator: drive the tensor cores, device memory and the training
step while an exporter watches. Ported from ``tpu_pod_exporter/loadgen/__main__.py``.

Examples:
    python -m tpu_pod_exporter_torch.loadgen --mode burn --seconds 30
    python -m tpu_pod_exporter_torch.loadgen --mode hbm --gib 8 --seconds 60
    python -m tpu_pod_exporter_torch.loadgen --mode sharded --devices 1 --seconds 30
    python -m tpu_pod_exporter_torch.loadgen --mode sharded --devices 4 --device cpu \\
        --width 64 --depth 2 --batch 16 --seconds 5
    python -m tpu_pod_exporter_torch.loadgen --mode parallel --program ring --scale 1024
    python -m tpu_pod_exporter_torch.loadgen --mode parallel --program fsdp --devices 2 \\
        --device cpu --seconds 2

Runs on the CUDA card unless ``--device cpu`` is given. A sharded mesh or a
parallel program of more than one device runs as a world of rank processes
(``run_world``).
"""

from __future__ import annotations

import argparse
import sys
import time

from tpu_pod_exporter_torch.loadgen.parallel import PARALLEL_PROGRAMS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpu_pod_exporter_torch.loadgen",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument(
        "--mode", choices=("burn", "hbm", "sharded", "parallel"), default="burn"
    )
    p.add_argument(
        "--program", default="ring", choices=PARALLEL_PROGRAMS,
        help="parallel mode: which collective pattern to loop",
    )
    p.add_argument(
        "--scale", type=int, default=1,
        help="parallel mode: tensor-dimension multiplier (bytes/step)",
    )
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--iters", type=int, default=10, help="forward passes per step (burn)")
    p.add_argument("--gib", type=float, default=1.0, help="device memory to hold (hbm mode)")
    p.add_argument("--devices", type=int, default=0,
                   help="mesh size (sharded, parallel); 0 = every card, or 1 on the CPU")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the card (default), or the CPU when asked")
    args = p.parse_args(argv)

    import torch

    from tpu_pod_exporter_torch.cudaenv import require_cuda

    dev = torch.device("cpu") if args.device == "cpu" else require_cuda()

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    deadline = time.monotonic() + args.seconds
    steps = 0

    if args.mode == "hbm":
        from tpu_pod_exporter_torch.loadgen.workload import hbm_fill

        buf = hbm_fill(int(args.gib * 1024**3), device=dev)
        gib = buf.numel() * buf.element_size() / 1024**3
        print(f"holding {gib:.2f} GiB on {buf.device}")
        while time.monotonic() < deadline:
            time.sleep(0.5)
        del buf
        return 0

    if args.mode == "burn":
        from tpu_pod_exporter_torch.loadgen.workload import burn_step, init_params

        params = init_params(width=args.width, depth=args.depth, device=dev)
        x = torch.ones((args.batch, args.width), dtype=torch.bfloat16, device=dev)
        burn_step(params, x, iters=args.iters)  # builds the kernels at first use
        sync()
        t0 = time.monotonic()
        deadline = t0 + args.seconds
        while time.monotonic() < deadline:
            # Feed the output back in: a real data dependency per step.
            x = burn_step(params, x, iters=args.iters)
            sync()
            steps += 1
        dt = time.monotonic() - t0
        flops = 2 * args.batch * args.width * args.width * args.depth * args.iters * steps
        print(f"{steps} steps in {dt:.1f}s → {flops / dt / 1e12:.2f} TFLOP/s")
        return 0

    import torch.distributed as dist

    from tpu_pod_exporter_torch.loadgen import sharded

    n = args.devices or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    if args.mode == "parallel":
        from tpu_pod_exporter_torch.loadgen import parallel

        if n == 1:
            try:
                report = parallel.run_loop(args.program, 1, args.scale, args.seconds,
                                           device=dev)
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
        else:
            report = sharded.run_world(
                n, dev.type,
                ["--program", args.program, "--scale", str(args.scale),
                 "--seconds", str(args.seconds)],
                timeout=args.seconds + 120, module=parallel.MODULE,
            )[0]
        if not report["finite"]:
            print(f"non-finite probe ({report['probe']}) after {report['steps']} steps",
                  file=sys.stderr)
            return 1
        dt = report["seconds"]
        print(f"{args.program} x{args.scale} on {n} devices: "
              f"{report['steps']} steps in {dt:.1f}s → {report['steps'] / dt:.1f} steps/s")
        return 0

    # sharded
    if n == 1:
        mesh = sharded.make_mesh(1, device=dev)
        try:
            # One step first (it builds the kernels), then the timed ones.
            report = sharded.train(mesh, args.width, args.depth, args.batch,
                                   steps=1, seconds=args.seconds)
        finally:
            dist.destroy_process_group()
    else:
        report = sharded.run_world(
            n, dev.type,
            ["--width", str(args.width), "--depth", str(args.depth),
             "--batch", str(args.batch), "--steps", "1", "--seconds", str(args.seconds)],
            timeout=args.seconds + 120,
        )[0]
    print(f"mesh {report['mesh']} | {report['steps']} steps in {report['seconds']:.1f}s "
          f"| loss {report['losses'][-1]:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
