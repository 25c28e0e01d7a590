"""Multi-process distributed BA entry point.

Port of `orb_slam3_ros2_tpu/parallel/multiproc.py`: each process joins a
`torch.distributed` group, and the landmark-sharded Schur BA
(`parallel/sharded_ba.py`) runs over the GLOBAL shard mesh, every process
holding `--local-devices` shards; the per-iteration psum of the reduced
camera system is the only cross-process traffic (O(K^2 * 36) bytes).

Run as a module, once per process:

    python -m orb_slam3_ros2_tpu_torch.parallel.multiproc \\
        --process-id 0 --num-processes 2 --coordinator 127.0.0.1:9901 \\
        --problem problem.npz --out out.npz --iters 10

`--coordinator` is `host:port` (a TCP rendezvous) or a `file://` path (a
file store, which needs no free port). The shards live on `--device`
(default the card; `--device cpu` on the CPU). `--backend` defaults to
NCCL for one process on the card and to gloo otherwise: NCCL refuses two
ranks on one card, and gloo reduces host copies of the (small) reduced
system. Process 0 writes the solved poses and cost to `--out` and prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def init_method(coordinator: str) -> str:
    """`host:port` -> tcp://host:port; a file:// or tcp:// URL as it is."""
    if coordinator.startswith(("file://", "tcp://")):
        return coordinator
    return f"tcp://{coordinator}"


def default_backend(device: torch.device, num_processes: int) -> str:
    return "nccl" if device.type == "cuda" and num_processes == 1 else "gloo"


def join_group(process_id: int, num_processes: int, coordinator: str,
               device: torch.device, backend=None) -> str:
    """Join the process group (a card for `device` is required); returns
    the backend used."""
    import torch.distributed as dist

    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --device cpu to run on "
                "the CPU")
        if device.index is not None:
            torch.cuda.set_device(device)
    backend = backend or default_backend(device, num_processes)
    dist.init_process_group(backend, init_method=init_method(coordinator),
                            world_size=num_processes, rank=process_id)
    return backend


def shard_devices(device: torch.device, local_devices: int) -> list:
    """This process's shards' devices: `local_devices` shards on `device`
    (0: one shard per visible card, or one on the CPU)."""
    if local_devices:
        return [device] * local_devices
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _build_problem(path: str, device: torch.device):
    from orb_slam3_ros2_tpu_torch.backend import ba as ba_mod

    d = np.load(path)

    def t(k, dtype=torch.float32):
        return torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=device)

    return ba_mod.BAProblem(
        R=t("R"), t=t("t"), X=t("X"), uv=t("uv"), w=t("w"),
        fixed=t("fixed", torch.bool), point_valid=t("point_valid", torch.bool),
    ), {k: float(d[k]) for k in ("fx", "fy", "cx", "cy")}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default="127.0.0.1:9901",
                    help="host:port, or a file:// path for a file store")
    ap.add_argument("--problem", required=True, help="npz with BA problem")
    ap.add_argument("--out", required=True,
                    help="npz written by process 0 (R, t, cost, timing)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--local-devices", type=int, default=0,
                    help="shards held by this process on --device "
                         "(0 = one per visible card)")
    ap.add_argument("--reps", type=int, default=1,
                    help="timed repetitions (beyond the warm-up run)")
    ap.add_argument("--device", default="cuda",
                    help="where the shards live (default the card)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="process-group backend (default: nccl for one "
                         "process on the card, else gloo)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from orb_slam3_ros2_tpu_torch.parallel import mesh as mesh_mod
    from orb_slam3_ros2_tpu_torch.parallel import sharded_ba

    device = torch.device(args.device)
    backend = join_group(args.process_id, args.num_processes,
                         args.coordinator, device, args.backend)
    try:
        problem, intr = _build_problem(args.problem, device)
        mesh = mesh_mod.make_mesh(
            devices=shard_devices(device, args.local_devices))
        n_dev = mesh.size
        ba = sharded_ba.make_sharded_ba(
            mesh, intr["fx"], intr["fy"], intr["cx"], intr["cy"],
            n_iters=args.iters)
        # each process takes only its own landmark shards
        p = sharded_ba.shard_problem(problem, mesh)
        out = ba(p)  # warm-up
        _sync(device)
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = ba(p)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        if args.process_id == 0:
            # R, t, cost are replicated: every process holds them
            np.savez(
                args.out,
                R=out.R.cpu().numpy(), t=out.t.cpu().numpy(),
                cost=out.cost.cpu().numpy(),
                wall_s=best, iters=args.iters,
                devices=n_dev, processes=args.num_processes,
            )
            print(json.dumps({
                "devices": n_dev, "processes": args.num_processes,
                "backend": backend, "device": str(device),
                "ba_iters_per_s": round(args.iters / best, 2),
                "final_cost": float(out.cost),
            }), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
