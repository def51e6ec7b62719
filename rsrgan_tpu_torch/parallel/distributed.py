"""Multi-process data parallelism (counterpart of
``rsrgan_tpu/parallel/distributed.py``): joining a world of processes,
the backend rule, and the launcher that ``--num_gpu=N`` uses.

One process is one rank, and a rank owns one device. ``initialize``
joins a world through a TCP rendezvous at ``host:port`` (rank 0 hosts
it), as ``jax.distributed.initialize`` joins the JAX processes through
its coordinator::

    python -m rsrgan_tpu_torch.cli.train ... \\
        --coordinator_address=host0:8476 \\
        --num_processes=2 --process_id=$RANK

The backend follows the layout, which the ranks exchange through the
rendezvous store before the group starts: ``nccl`` where every rank holds
a card of its own, ``gloo`` where ranks share a card and on the CPU
(NCCL refuses two ranks on one device). The data layer uses only
``all_reduce`` and ``broadcast``, the two collectives gloo runs on CUDA
tensors.

``launch`` runs one function in N processes that
``torch.multiprocessing`` spawns, on a free localhost port (``--num_gpu=N``
in one command, and the tests' gloo worlds): it returns the first
non-zero exit code, and ends every child that is still running when one
fails, when its time runs out, or when the caller is interrupted.
"""

from __future__ import annotations

import datetime
import socket
import sys
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# how long a collective or the rendezvous waits for the other ranks
TIMEOUT = datetime.timedelta(minutes=30)

_CARD_KEY = "rsrgan/card/{}"


def free_port() -> int:
    """A free TCP port on localhost (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def card_identity(device: torch.device) -> str:
    """What tells two ranks' devices apart: the card's UUID, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(device).uuid)


def backend_for(cards: Sequence[str]) -> str:
    """The layout's backend: ``nccl`` when every rank has a card of its
    own, ``gloo`` when two ranks share one or the ranks are on the CPU."""
    if any(c == "cpu" for c in cards) or len(set(cards)) < len(cards):
        return "gloo"
    return "nccl"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[torch.device] = None) -> Tuple[int, int]:
    """Join the world at ``coordinator_address`` (``host:port``) as rank
    ``process_id`` of ``num_processes``, on ``device`` (the CPU by
    default); a no-op without an address. Returns (rank, world): (0, 1)
    in a single process."""
    if not coordinator_address:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator_address needs --num_processes and "
                         "--process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id={process_id} is not in "
                         f"[0, {num_processes})")
    device = torch.device("cpu") if device is None else device
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=TIMEOUT)
    store.set(_CARD_KEY.format(process_id), card_identity(device))
    cards = [store.get(_CARD_KEY.format(r)).decode()
             for r in range(num_processes)]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(cards), store=store,
                            rank=process_id, world_size=num_processes,
                            timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def is_coordinator() -> bool:
    """True on the process that writes checkpoints, snapshots, metrics
    and TensorBoard files: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the world (after the last collective); a no-op without one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable[..., int], world: int, port: int,
               args: tuple) -> None:
    rc = fn(rank, world, f"127.0.0.1:{port}", *args)
    sys.stdout.flush()
    if rc:
        sys.exit(int(rc))


def launch(fn: Callable[..., int], nprocs: int, args: tuple = (),
           timeout: Optional[float] = None) -> int:
    """Run ``fn(rank, nprocs, address, *args)`` in ``nprocs`` spawned
    processes that rendezvous at ``address`` (a free localhost port);
    ``fn`` returns its exit code. Returns 0 when every rank exits 0, else
    the code of the first rank that failed (1 where it raised; its
    traceback goes to stderr); the others are then ended. Past
    ``timeout`` seconds it raises ``TimeoutError``. Every child still
    alive on the way out is terminated, then killed."""
    ctx = mp.start_processes(_rank_main,
                             args=(fn, nprocs, free_port(), args),
                             nprocs=nprocs, join=False, daemon=True,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(None if deadline is None else
                           max(0.0, deadline - time.monotonic()),
                           grace_period=5):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{nprocs} ranks still running after {timeout} s")
        return 0
    except mp.ProcessRaisedException as e:
        print(e, file=sys.stderr, flush=True)
        return 1
    except mp.ProcessExitedException as e:
        return e.exit_code
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
