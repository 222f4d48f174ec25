"""Can two gloo ranks on ONE card exchange CUDA tensors?

    python tools/gloo_cuda_probe.py [--mib M]

NCCL refuses two ranks on one card, so a P = 2 run of the port on one card
needs gloo to take CUDA tensors (which it stages through the host).  This
spawns two processes on cuda:0, joins them in a gloo group over
tcp://localhost, and runs the three collectives the relational path issues
on CUDA tensors: ``all_to_all_single`` (the exchange), ``all_gather`` (the
results, the exclusive scans) and ``all_reduce``; each result is checked
against what the ranks sent.  Then it times an ``all_to_all_single`` of M
MiB a rank (CUDA events around the call), gloo's host staging included.
Prints the card's name and power limit, one JSON line per rank, and exits
with the first rank's error when a collective is refused or wrong.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, mib: int) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    out = {"rank": rank, "torch": torch.__version__,
           "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)}
    try:
        # all_to_all_single: rank r sends value 100 r + j to rank j
        x = torch.arange(world, dtype=torch.int32, device=dev) + 100 * rank
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        want = torch.arange(world, dtype=torch.int32) * 100 + rank
        assert y.is_cuda and torch.equal(y.cpu(), want), y
        out["all_to_all_single"] = y.tolist()
        parts = [torch.empty(3, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((3,), float(rank), device=dev))
        assert all(p.is_cuda and bool((p == i).all())
                   for i, p in enumerate(parts)), parts
        out["all_gather"] = [p.tolist() for p in parts]
        s = torch.tensor([rank + 1.0], device=dev)
        dist.all_reduce(s)
        assert float(s) == world * (world + 1) / 2, s
        out["all_reduce"] = float(s)
        # the rate of one large exchange, host staging included
        n = mib * 2**20 // 4
        big = torch.full((n,), rank, dtype=torch.int32, device=dev)
        got = torch.empty_like(big)
        times = []
        for _ in range(3):
            dist.barrier()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            dist.all_to_all_single(got, big)
            b.record()
            torch.cuda.synchronize()
            times.append({"host_s": round(time.perf_counter() - t0, 4),
                          "events_ms": round(a.elapsed_time(b), 3)})
        half = n // world
        assert all(bool((got[i * half:(i + 1) * half] == i).all())
                   for i in range(world))
        out[f"all_to_all_single_{mib}_mib"] = times
        out["ok"] = True
    except Exception:   # report the refusal, then fail the run
        out["ok"] = False
        out["error"] = traceback.format_exc(limit=4)
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    if not out["ok"]:
        sys.exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, 2, args.port, args.mib)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gloo_cuda_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r), "--port", str(port),
                               "--mib", str(args.mib)]) for r in range(2)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(json.dumps({"exit_codes": codes}), flush=True)
    return 0 if codes == [0, 0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
