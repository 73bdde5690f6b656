"""The port's launcher: one process a device, joined by torch.distributed.

    python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node N [--nodes M --node-rank R
        --coordinator HOST:PORT] (script.py | -m module) [args...]

The port of `dlrm_flexflow_tpu/launch.py`. The JAX package runs one process
a host and its script in-process after `jax.distributed.initialize`; the
port runs one process a device, so the launcher starts N local processes
of the script, each with RANK = node_rank * N + local rank, WORLD_SIZE = M *
N, LOCAL_RANK, LOCAL_WORLD_SIZE = N, MASTER_ADDR and MASTER_PORT (the
coordinator: given, or a free local port on one node). The script joins the
group with `initialize()`. If a process exits non-zero the launcher ends
the others and exits with its code; it stops every process it started,
also when it is itself interrupted.

`initialize(device)` joins the default process group from those variables:
NCCL for "cuda" (after making this rank's card, LOCAL_RANK, the current
one; it raises without CUDA or with fewer visible cards than local ranks),
gloo for "cpu". It never changes one backend for the other. A process
started without the launcher is a world of one.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

import torch
import torch.distributed as dist

_POLL_S = 0.05
_GRACE_S = 10.0  # how long an ended rank's peers get to exit on SIGTERM before SIGKILL


def initialize(device: str = "cuda", coordinator: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """Join the default process group (no-op if this process already has
    one). Rank, world size and coordinator come from the arguments, else
    from the launcher's environment, else a world of one."""
    if dist.is_initialized():
        return
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch.initialize(device='cuda'): no CUDA device is available; pass "
                               "device='cpu' for a gloo group on the CPU")
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if torch.cuda.device_count() < local_world:
            raise RuntimeError(f"{local_world} ranks on this host but {torch.cuda.device_count()} visible "
                               "CUDA devices: a rank never shares a card")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"launch.initialize: device {device!r} is neither cuda nor cpu")
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if coordinator is None:
        if world != 1:
            raise RuntimeError(f"launch.initialize: a world of {world} needs a coordinator (run under "
                               "python -m dlrm_flexflow_tpu_torch.launch)")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=rank, world_size=world)


def _free_port() -> int:
    """A port free on every local address: rank 0's store listens on all of
    them, so a port free on the loopback alone can still be taken on
    another address (EADDRINUSE at `init_process_group`)."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _usage(msg: str) -> None:
    print(f"launch: {msg}\nusage: python -m dlrm_flexflow_tpu_torch.launch --nproc-per-node N "
          "[--nodes M --node-rank R --coordinator HOST:PORT] (script.py | -m module) [args...]",
          file=sys.stderr)
    sys.exit(2)


def _stop(procs: List[subprocess.Popen]) -> None:
    """SIGTERM to every process still running, SIGKILL after the grace."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + _GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    nproc, nodes, node_rank, coordinator = 1, 1, 0, None
    target: List[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a in ("--nproc-per-node", "--nodes", "--node-rank", "--coordinator"):
            if i + 1 >= len(args):
                _usage(f"{a} takes a value")
            value = args[i + 1]
            if a == "--coordinator":
                coordinator = value
            else:
                try:
                    n = int(value)
                except ValueError:
                    _usage(f"{a} takes an integer, got {value!r}")
                nproc, nodes, node_rank = {"--nproc-per-node": (n, nodes, node_rank),
                                           "--nodes": (nproc, n, node_rank),
                                           "--node-rank": (nproc, nodes, n)}[a]
            i += 2
        elif a == "-m":
            if i + 1 >= len(args):
                _usage("-m takes a module")
            target = ["-m", *args[i + 1:]]
            break
        else:
            target = args[i:]
            break
    if not target:
        _usage("no script")
    if nproc < 1 or nodes < 1 or not 0 <= node_rank < nodes:
        _usage(f"--nproc-per-node {nproc}, --nodes {nodes}, --node-rank {node_rank}")
    if coordinator is None:
        if nodes > 1:
            _usage("--coordinator HOST:PORT is needed with --nodes > 1")
        coordinator = f"127.0.0.1:{_free_port()}"
    host, _, port = coordinator.rpartition(":")
    procs: List[subprocess.Popen] = []
    code = 0
    # a SIGTERM to the launcher unwinds through the finally below
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
    try:
        for local in range(nproc):
            env = {**os.environ, "RANK": str(node_rank * nproc + local), "WORLD_SIZE": str(nodes * nproc),
                   "LOCAL_RANK": str(local), "LOCAL_WORLD_SIZE": str(nproc),
                   "MASTER_ADDR": host, "MASTER_PORT": port}
            procs.append(subprocess.Popen([sys.executable, *target], env=env))
        running = set(range(nproc))
        while running and code == 0:
            for r in sorted(running):
                rc = procs[r].poll()
                if rc is None:
                    continue
                running.discard(r)
                if rc != 0:
                    print(f"launch: local rank {r} exited with {rc}; stopping the others", file=sys.stderr)
                    code = rc if rc > 0 else 128 - rc
                    break
            time.sleep(_POLL_S)
    finally:
        _stop(procs)
    return code


if __name__ == "__main__":
    sys.exit(main())
