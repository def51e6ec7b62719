"""Driver: the flagship's data-parallel training loop, one rank a card,
as ``--num_gpu=N`` runs it (``run_gan_rnn.sh:62,73``): every rank runs
``train_gathered``'s ``Session`` on its own card, with the whole corpus
in its own ``DeviceFeed`` tables (as the CLI's ranks each hold them), its
row block of every global batch (``rank_plans``), the learning rates x N
(as ``make_hparams(args, N)`` gives) and one all-reduce of each update's
gradients and metrics over NCCL (gloo on the CPU).

This process is rank 0: it times the window and traces it. Ranks 1..N-1
are started with ``parallel.distributed.launch`` (spawned processes,
from a thread of this one) and join the world at a free localhost port.
They run what rank 0 runs, step for step: the checked iterations and
the warm-up alike, and in a window the steps rank 0 has granted. A
grant (a key in a second TCP store, ``ctl``) names the step through
which the others may go; rank 0 grants ``2 * LOOKAHEAD`` steps past its
own whenever it comes within ``LOOKAHEAD`` of the last grant (one store
write every ``LOOKAHEAD`` steps) and never waits for the others. Each
step's all-reduce keeps the ranks within a step of one another, so no
rank waits for a grant. Where rank 0's clock ends the window it runs the
steps it granted but had not run, after the window's sync and outside
its time, then grants nothing more: every rank stops at the same step.
``free`` ends the world: the ranks compare their parameters with rank
0's (``replica_gap``: the largest absolute difference of any element of
any parameter; 0 where every update left the replicas equal), report
their peak memory and exit.

Frames are the global batch's true frames. The reference
(``reference/<reference>.py``) follows the first three global batches
(all N ranks' rows) at the rates x N, from the same weights and D noise.
"""

from __future__ import annotations

import copy
import os
import sys
import threading
import time
from datetime import timedelta
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import check, harness, roofline
from benchmark.drivers import train_gathered
from benchmark.trace import Tracer

CTL_TIMEOUT = timedelta(minutes=20)   # a rank's wait for rank 0's word
LOOKAHEAD = 4   # steps a window's grant runs ahead of rank 0's own
LAUNCH_TIMEOUT = 3 * 3600.0


def scaled_cell(cell: harness.Cell, n: int) -> harness.Cell:
    """``cell`` as one rank of ``n`` sees it: the mix's batch (a card's,
    as ``--batch_size`` is with ``--num_gpu``) x ``n``, the global batch
    the batcher plans, and the learning rates x ``n``, in the flags the
    program is built from and in the hyper-parameters the reference
    reads."""
    cfg = copy.deepcopy(cell.config)
    hp = cfg["hparams"]
    hp["g_lr"], hp["d_lr"] = hp["g_lr"] * n, hp["d_lr"] * n
    flags = {"--g_learning_rate": hp["g_lr"], "--d_learning_rate": hp["d_lr"]}
    cfg["cli"] = [f for f in cfg["cli"] if f.split("=")[0] not in flags]
    cfg["cli"] += [f"{k}={v!r}" for k, v in flags.items()]
    mix = dict(cell.mix, batch_size=cell.mix["batch_size"] * n)
    return harness.Cell(cell.name, cell.entry, cell.workload, cfg, mix)


def _device(device_type: str, rank: int) -> torch.device:
    return (torch.device("cuda", rank) if device_type == "cuda"
            else torch.device("cpu"))


def _join(ctx: harness.Ctx, rank: int, n: int, ports):
    """This rank in the world of ``n`` (``ports``: the world's and the
    control store's); returns the control store."""
    from rsrgan_tpu_torch.parallel import initialize, make_world
    ctl = torch.distributed.TCPStore("127.0.0.1", ports[1], n,
                                     is_master=rank == 0,
                                     timeout=CTL_TIMEOUT)
    initialize(f"127.0.0.1:{ports[0]}", n, rank, ctx.device)
    make_world(ctx.device)
    return ctl


def _follower(local: int, _nprocs: int, _address: str, cell: harness.Cell,
              seed: int, n: int, ports, device_type: str) -> int:
    """Rank ``local + 1`` (``launch``'s function): the same Session as
    rank 0, its steps opened by rank 0."""
    rank = local + 1
    device = _device(device_type, rank)
    if device.type == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    ctx = harness.Ctx(cell=cell, seed=seed, seconds=0.0,
                      tracer=Tracer(False, device), device=device,
                      t0=time.monotonic())
    ctl = _join(ctx, rank, n, ports)
    s = Session(ctx, rank=rank, ctl=ctl)
    s.warm()
    s.follow()
    return 0


class Session(train_gathered.Session):
    """``train_gathered.Session`` on one rank of a world of the cell's
    ``chips``; on rank 0 it starts the others and holds the global
    batches for the reference."""

    def __init__(self, ctx: harness.Ctx, rank: int = 0, ctl=None):
        from rsrgan_tpu_torch.parallel import free_port, launch

        n = int(ctx.cell.entry["chips"])
        self.world_size, self.rank = n, rank
        self.replica_gap = float("nan")
        self.peaks: Dict[int, int] = {}
        self._gate = None
        self._commands = 0
        self._threads = torch.get_num_threads()
        self._ranks = None
        self._ended = False
        if rank == 0:
            if ctx.device.type == "cpu":   # the ranks share the host's cores
                torch.set_num_threads(max(1, self._threads // n))
            ports = (free_port(), free_port())
            out: list = []
            self._ranks = (threading.Thread(
                target=lambda: out.append(launch(
                    _follower, n - 1, timeout=LAUNCH_TIMEOUT,
                    args=(ctx.cell, ctx.seed, n, ports, ctx.device.type))),
                daemon=True), out)
            self._ranks[0].start()
            threading.Thread(target=self._watch, daemon=True).start()
            ctl = _join(ctx, 0, n, ports)
        self.ctl = ctl
        try:
            self._start(ctx, n)
        except BaseException:
            if rank == 0:
                self._leave()
            raise

    def _start(self, ctx: harness.Ctx, n: int) -> None:
        """``train_gathered``'s set-up on this rank, each later step
        opened by rank 0; on rank 0 the global plans too."""
        from rsrgan_tpu_torch.cli.train import dispatch_plans, parse_args
        from rsrgan_tpu_torch.data import SequenceBatcher
        cell = scaled_cell(ctx.cell, n)
        super().__init__(harness.Ctx(
            cell=cell, seed=ctx.seed, seconds=ctx.seconds, tracer=ctx.tracer,
            device=ctx.device, t0=ctx.t0))
        self._inner = inner = self.step

        def step(indices, t_pad):
            if self._gate is not None:   # rank 0 grants steps ahead
                c, k, granted, j = self._gate
                if k + LOOKAHEAD > granted:
                    granted = k + 2 * LOOKAHEAD
                    self.ctl.set(f"win{c}/{j}", str(granted))
                    j += 1
                self._gate = (c, k + 1, granted, j)
            return inner(indices, t_pad)
        self.step = step
        if self.rank:
            return
        # the global plans, in the order the ranks walk their blocks of
        # them: their true frames, and the first batches for the reference
        mix, corpus = cell.mix, harness.generator(cell.mix)
        batcher = SequenceBatcher(
            train_gathered._Index(self.lens, 1, 1), mix["batch_size"],
            shuffle=True, seed=mix["order_seed"])
        plans = dispatch_plans(
            [[(ix, batcher.plan_t_pad(ix))
              for ix in batcher.iter_index_batches()]],
            max(1, parse_args(self.cfg["cli"])[0].steps_per_call))
        checked = train_gathered.CHECKED_ITERATIONS
        self.global_frames = {
            id(local): int(self.lens[np.asarray(ix)].sum())
            for (local, _), (ix, _) in zip(self.queue, plans[checked:])}
        feed, self.batches = self.feed, []
        for ix, t_pad in plans[:checked]:
            ix = np.asarray(ix)
            first = feed.starts[ix].astype(np.int64)
            self.batches.append((
                corpus.rows(feed.inputs_tbl, first, self.lens[ix], t_pad),
                corpus.rows(feed.labels_tbl, first, self.lens[ix], t_pad),
                torch.as_tensor(self.lens[ix], dtype=torch.int64,
                                device=self.device)))

    def _watch(self) -> None:
        """Rank 0: end this process where another rank failed before the
        world ended (rank 0 would otherwise wait in a rendezvous or a
        collective until its timeout)."""
        thread, out = self._ranks
        thread.join()
        if not self._ended and out != [0]:
            print(f"benchmark: a rank of the world failed ({out}); "
                  "rank 0 ends", file=sys.stderr, flush=True)
            os._exit(1)

    def _leave(self) -> None:
        """Rank 0 out of the world after a failure: the process's world
        back to one, its threads as they were."""
        from rsrgan_tpu_torch.parallel import make_world, shutdown
        self._ended = True
        shutdown()
        make_world(torch.device("cpu"))
        torch.set_num_threads(self._threads)

    # -- rank 0's word to the others ----------------------------------------

    def _command(self, op: str) -> int:
        c = self._commands
        self.ctl.set(f"cmd/{c}", op)
        self._commands += 1
        return c

    def follow(self) -> None:
        """Ranks 1..N-1: each window's steps as rank 0 opens them, then
        the end (``free``)."""
        c = 0
        while True:
            op = self.ctl.get(f"cmd/{c}").decode()
            if op == "window":
                k = granted = j = 0
                while True:
                    if k == granted:   # the next grant; the same: stop
                        grant = int(self.ctl.get(f"win{c}/{j}"))
                        j += 1
                        if grant == granted:
                            break
                        granted = grant
                    self.step(*self.queue[k])
                    k += 1
                train_gathered._sync(self.device)
            elif op == "free":
                self._end()
                return
            c += 1

    def window(self, seconds: float, traced: bool = False,
               most: Optional[int] = None) -> dict:
        """Rank 0's window (``train_gathered``'s), its steps granted to the
        other ranks ahead; then the granted steps it did not run, outside
        the window. Frames are the global batches'."""
        c = self._command("window")
        self._gate = (c, 0, 0, 0)
        try:
            w = super().window(seconds, traced, most)
            _, ran, granted, _ = self._gate
            for k in range(ran, granted):
                self._inner(*self.queue[k])
            train_gathered._sync(self.device)
        finally:
            _, _, granted, j = self._gate
            self.ctl.set(f"win{c}/{j}", str(granted))
            self._gate = None
        w["frames"] = sum(self.global_frames[id(ix)]
                          for ix, _ in self.queue[:w["iterations"]])
        return w

    def _end(self) -> None:
        """Every rank: the parameters against rank 0's (the largest
        absolute difference, over the world), each rank's peak memory to
        the control store, then out of the world."""
        import torch.distributed as dist

        from rsrgan_tpu_torch.parallel import make_world, shutdown
        flat = torch.cat([p.detach().reshape(-1).float()
                          for net in (self.state.g, self.state.d)
                          for _, p in sorted(net.params().items())])
        first = flat.clone()
        dist.broadcast(first, src=0)
        gap = (flat - first).abs().max().reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        self.replica_gap = float(gap)
        if self.device.type == "cuda":
            self.ctl.set(f"peak/{self.rank}", str(
                torch.cuda.max_memory_allocated(self.device)))
        dist.barrier()
        shutdown()
        make_world(torch.device("cpu"))

    def free(self) -> None:
        """Rank 0: end the world (``_end``), wait for the other ranks,
        then drop the program's state and the tables."""
        self._ended = True
        self._command("free")
        self._end()
        thread, out = self._ranks
        thread.join()
        if not out or out[0] != 0:
            raise RuntimeError(f"a rank of the world failed: {out}")
        if self.device.type == "cuda":
            self.peaks = {r: int(self.ctl.get(f"peak/{r}"))
                          for r in range(self.world_size)}
        torch.set_num_threads(self._threads)
        super().free()

    def numbers(self, side: Optional[dict], ref: dict) -> dict:
        """``train_gathered``'s numbers, and for the program the replicas'
        largest difference (a reference has one replica: 0)."""
        out = super().numbers(side, ref)
        out["replica_gap"] = self.replica_gap if side is None else 0.0
        return out


def comm_counts(iterations: int) -> Dict[str, float]:
    """The traced window's all-reduces and their bytes an iteration (the
    program's ``comm.all_reduce`` spans and ``comm.bytes`` counter;
    nothing for a program without them)."""
    try:
        from rsrgan_tpu_torch import spans
    except ImportError:
        return {}
    r = spans.read()
    calls = r.units("comm.all_reduce")
    if not calls or not iterations:
        return {}
    return {"all_reduce_per_iter": calls / iterations,
            "bytes_per_iter": r.total("comm.bytes") / iterations}


def run(ctx: harness.Ctx) -> dict:
    s = Session(ctx)
    s.warm()
    setup_s = time.monotonic() - ctx.t0
    w = s.window(ctx.seconds)
    traced = (s.window(ctx.seconds, traced=True, most=w["iterations"])
              if ctx.tracer.active else None)
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    probe_ms = harness.host_probe_ms()
    # the world ended and the state freed, the reference follows the
    # checked global batches
    s.free()
    numbers = s.numbers(None, s.reference())
    del w["events"], w["per_iter"]
    run = {"kind": "train", "setup_s": setup_s, **w,
           "attempted": w["iterations"], "memory_peak_bytes": peak,
           "checks": check.judge(numbers, ctx.cell.workload["limits"]),
           "numbers": numbers, "dtype_name": s.dtype_name,
           # a card's share: the model FLOPs of its rows
           "flops_per_frame": roofline.gan_iteration_flops(s.cfg)
           / s.world_size,
           "probe_ms": probe_ms, "trace": None}
    if traced is not None:
        from benchmark import trace
        events = traced.pop("events")
        traced["paced_s"] = sum(w["iter_ms"][:traced["iterations"]]) / 1e3
        run["attempted"] += traced["iterations"]
        run["failed"] += traced["failed"]
        run.update(trace=trace.analyse(events), traced=traced)
        run["breakdown"] = trace.breakdown(run["trace"])
        comm = comm_counts(traced["iterations"])
        if comm:
            run["breakdown"]["comm"] = [[k, v] for k, v in comm.items()]
        if s.peaks:
            run["breakdown"]["memory_peak_bytes_by_rank"] = [
                [r, b] for r, b in sorted(s.peaks.items())]
    return run
