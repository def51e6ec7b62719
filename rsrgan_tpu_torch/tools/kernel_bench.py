"""Segment microbenchmarks of the flagship training step on the card.

The counterpart of the repo's ``tools/kernel_bench.py``: each sequential
segment of the 1 D + 2 G GAN iteration timed in isolation, at B=16,
T=500, bf16, on the same numpy-seeded parameters (seed 0, the JAX
layout), through the port's ``ops/wavefront_stack.py``
``lstm_stack_wavefront``:

  g_infer    res_lstm_l 4-layer forward, decode mode (K4, save_acts=False)
  g_fwd      the same in train mode (K4, save_acts=True)
  g_fwdbwd   train forward + StackFn's per-layer reverse (K2 at G width)
  d_fwd2b    discriminator 2-layer forward at 2B rows, train mode (K4 at
             D width: the stacked D(real)/D(fake) pass of a D step)
  d_fwdbwd   D forward + backward at B rows (K4, then K2 at D width)
  full       GanTrainer.train_step (1 D + 2 G), built as bench.py builds
             it (K4, K1 and K3 at D width, K2)

    python3 -m rsrgan_tpu_torch.tools.kernel_bench [B] [T] [full]
        [--device=cuda|cpu]

(a literal ``full`` skips the segments). Each timing is K=20 back-to-back
applications between two CUDA events (the host clock on the CPU), every
input depending on the previous output (x0 + c, c += 1e-30 * sum(out)),
so the work can neither overlap nor be skipped, and the host's setup of
every launch is inside the window; the minimum of 4 repetitions after a
warm-up. ``full`` loops ``train_step`` K times (``train_multi_step`` is
not ported). Prints the card's ``name, power.limit``, a line
``name  ms  (frames/s)`` a segment, then one JSON line with every
segment's ms.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from rsrgan_tpu_torch.ops.wavefront_stack import lstm_stack_wavefront
from rsrgan_tpu_torch.tools import card

G_SIZES = dict(L=4, D=257, U=760, P=257)
D_SIZES = dict(L=2, D=40, U=256, P=40)
K = 20      # applications a timed window
REPS = 4    # timed windows, the least taken


def make_params(rng, L, D, U, P, scale=0.05) -> List[Dict[str, np.ndarray]]:
    """The JAX tool's ``make_params``: per-layer JAX-layout f32 arrays
    (``kernel`` [D+P, 4U], zero ``bias``, ``proj_kernel``, the peepholes),
    drawn in its order."""
    out = []
    for _ in range(L):
        out.append({
            "kernel": rng.normal(0, scale, (D + P, 4 * U)).astype(np.float32),
            "bias": np.zeros((4 * U,), np.float32),
            "proj_kernel": rng.normal(0, scale, (U, P)).astype(np.float32),
            "w_i_diag": rng.normal(0, scale, (1, U)).astype(np.float32),
            "w_f_diag": rng.normal(0, scale, (1, U)).astype(np.float32),
            "w_o_diag": rng.normal(0, scale, (1, U)).astype(np.float32),
        })
        D = P
    return out


def to_device(params, device) -> List[Dict[str, torch.Tensor]]:
    return [{k: torch.from_numpy(v).to(device) for k, v in p.items()}
            for p in params]


def g_infer(x, lengths, params, cdt):
    # decode path: no saved-activation stream (save_acts=False)
    return lstm_stack_wavefront(x, lengths, params, residual=True,
                                compute_dtype=cdt, save_acts=False)


def g_fwd(x, lengths, params, cdt):
    with torch.no_grad():
        return lstm_stack_wavefront(x, lengths, params, residual=True,
                                    compute_dtype=cdt, save_acts=True)


def _leaves(params):
    return [{k: v.detach().requires_grad_(True) for k, v in p.items()}
            for p in params]


def g_fwdbwd(x, lengths, params, cdt):
    """d sum(y * y) / d params; layer 1's kernel gradient."""
    leaves = _leaves(params)
    with torch.enable_grad():
        y = lstm_stack_wavefront(x, lengths, leaves, residual=True,
                                 compute_dtype=cdt, save_acts=True)
        grads = torch.autograd.grad(
            (y * y).sum(), [v for p in leaves for v in p.values()])
    return grads[0]


def d_fwd2b(x, lengths, params, cdt):
    with torch.no_grad():
        return lstm_stack_wavefront(x, lengths, params, residual=False,
                                    compute_dtype=cdt, save_acts=True)


def d_fwdbwd(x, lengths, params, cdt):
    """d sum(y * y) / d x."""
    xin = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y = lstm_stack_wavefront(xin, lengths, params, residual=False,
                                 compute_dtype=cdt, save_acts=True)
        return torch.autograd.grad((y * y).sum(), [xin])[0]


SEGMENTS = {"g_infer": g_infer, "g_fwd": g_fwd, "g_fwdbwd": g_fwdbwd,
            "d_fwd2b": d_fwd2b, "d_fwdbwd": d_fwdbwd}


def min_ms(run: Callable[[], None], k: int, device) -> float:
    """ms per application: the least of REPS windows of ``run()`` (K
    applications each) after a warm-up; CUDA events on a card."""
    run()
    card.sync(device)
    reps = []
    for _ in range(REPS):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            run()
            end.record()
            end.synchronize()
            reps.append(start.elapsed_time(end) / k)
        else:
            t0 = time.perf_counter()
            run()
            reps.append((time.perf_counter() - t0) * 1e3 / k)
    return min(reps)


def chain(fn, x0, lengths, params, cdt, k: int) -> Callable[[], None]:
    """K applications of ``fn``, each on x0 + c with c carried from the
    previous output."""
    def run():
        c = torch.zeros((), device=x0.device)
        for _ in range(k):
            c = c + 1e-30 * fn(x0 + c, lengths, params, cdt).float().sum()
    return run


def flagship_trainer(g_params, d_params, device, cdt=torch.bfloat16):
    """``bench.py``'s trainer: res_lstm_l G and LSTM-D on the wavefront,
    1 D + 2 G, l2 0, clip 15; the LSTM layers from the segments' numpy
    parameters (``models/bridge.py``), the dense layers seeded."""
    from rsrgan_tpu_torch.models import get_discriminator, get_generator
    from rsrgan_tpu_torch.models.bridge import (load_flax_params,
                                                module_tree)
    from rsrgan_tpu_torch.training import GanTrainer
    gen = torch.Generator().manual_seed(0)
    g = get_generator("res_lstm_l", input_dim=257, output_dim=40,
                      compute_dtype=cdt, lstm_impl="wavefront",
                      generator=gen)
    d = get_discriminator("lstm", compute_dtype=cdt, lstm_impl="wavefront",
                          generator=gen)
    g_tree = {**module_tree(g), **{f"lstm_cell_{k + 1}": p
                                   for k, p in enumerate(g_params)}}
    d_tree = module_tree(d)
    d_tree["StackedLstm_0"] = {f"cell_{k}": p
                               for k, p in enumerate(d_params)}
    load_flax_params(g, g_tree)
    load_flax_params(d, d_tree)
    return GanTrainer(g.to(device), d.to(device), output_dim=40,
                      input_dim=257, disc_updates=1, gen_updates=2,
                      l2_scale=0.0, max_grad_norm=15.0)


HPARAMS = {"g_lr": 8e-5, "d_lr": 1e-3, "mse_lambda": 10.0,
           "disc_noise_std": 0.05, "d_real": 1.0, "d_fake": 0.0}


def main(argv=None) -> int:
    from rsrgan_tpu_torch.device import resolve_device
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.tools.kernel_bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("B", nargs="?", type=int, default=16)
    p.add_argument("T", nargs="?", type=int, default=500)
    p.add_argument("only", nargs="?", choices=["full"], default=None,
                   help="full: only the full step")
    card.add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(card.card_line(device), flush=True)
    B, T = args.B, args.T
    cdt = torch.bfloat16

    rng = np.random.default_rng(0)
    g_np = make_params(rng, **G_SIZES)
    d_np = make_params(rng, **D_SIZES)
    g_params, d_params = to_device(g_np, device), to_device(d_np, device)

    def tensor(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(device)

    xg, xd, xd2 = tensor((B, T, 257)), tensor((B, T, 40)), tensor(
        (2 * B, T, 40))
    lg = torch.full((B,), T, dtype=torch.int32, device=device)
    ld2 = torch.full((2 * B,), T, dtype=torch.int32, device=device)
    results = {}

    def report(name, ms):
        results[name] = ms
        print(f"{name:10s} {ms:8.3f} ms  ({B * T / (ms / 1e3):,.0f} "
              "frames/s)", flush=True)

    if args.only != "full":
        for name, x, lens, prm in (("g_infer", xg, lg, g_params),
                                   ("g_fwd", xg, lg, g_params),
                                   ("g_fwdbwd", xg, lg, g_params),
                                   ("d_fwd2b", xd2, ld2, d_params),
                                   ("d_fwdbwd", xd, lg, d_params)):
            report(name, min_ms(chain(SEGMENTS[name], x, lens, prm, cdt, K),
                                K, device))

    # full training step (1 D + 2 G), as bench.py builds it
    trainer = flagship_trainer(g_np, d_np, device, cdt)
    y = tensor((B, T, 40))
    state = trainer.init_state()
    noise = torch.Generator(device=device).manual_seed(1)

    def steps():
        for _ in range(K):
            m = trainer.train_step(state, xg, y, lg, HPARAMS, noise)
        float(m["g_loss"])
    report("full", min_ms(steps, K, device))
    print(json.dumps({"metric": "kernel_bench_ms", "B": B, "T": T, "K": K,
                      "dtype": "bfloat16", **results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
