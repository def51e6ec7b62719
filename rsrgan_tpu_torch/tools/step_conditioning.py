"""How far a SEGAN train step in f32 lies from the same step in f64, on
the CPU: the conditioning that bounds any comparison of two f32 runs of
the step (the card's against the CPU's in ``chip_smoke.py``).

    python -m rsrgan_tpu_torch.tools.step_conditioning [--wave] [--rows N]

The trainer is ``cli/train.py``'s for recipes/run_segan.sh's flags (the
conv auto-encoder G, or with ``--wave`` the WaveNet-style one), seeded
weights, ``init_state`` on seeded rows (labels a fixed function of the
center frame), both nets' optimizer moments off zero
(``moments_off_zero``), z and D's noise from one seeded generator. One
JSON line: per gradient and per post-step parameter the largest
|f32 - f64| over the largest |f64| of the tensor, the worst few, and the
losses' relative gaps.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rsrgan_tpu_torch.cli import train as train_cli
from rsrgan_tpu_torch.models import segan as segan_models
from rsrgan_tpu_torch.training import segan as segan_training

SEGAN_FLAGS = ["--trainer=segan", "--g_type=ae", "--disc_updates=1",
               "--gen_updates=1", "--bias_deconv=True", "--input_dim=257",
               "--output_dim=40", "--left_context=3", "--right_context=3",
               "--seed=61"]
HP = {"g_lr": 1e-3, "d_lr": 1e-3, "l1_lambda": 100.0,
      "disc_noise_std": 0.05}


def moments_off_zero(net, seed: int) -> None:
    """Set a NetState's optimizer moments as after earlier steps: Adam's
    count 3, its mu ~ N(0, 1e-2); Adam's and RMSProp's nu in
    [1e-4, 1e-3]. From zero moments a first Adam or RMSProp step moves
    an element by about +-lr (RMSProp: +-3.16 lr) on the sign of its
    gradient, so two runs whose gradients differ by rounding part by a
    whole step wherever a gradient lies near zero; with the moments off
    zero the step is a smooth function of the gradient."""
    gen = torch.Generator().manual_seed(seed)
    for field, moments in net.opt_state.items():
        if field == "count":
            net.opt_state[field] = torch.full_like(moments, 3)
            continue
        for k, m in moments.items():
            u = (torch.randn(m.shape, generator=gen) * 1e-2 if field == "mu"
                 else 1e-4 + 9e-4 * torch.rand(m.shape, generator=gen))
            moments[k] = u.to(device=m.device, dtype=m.dtype)


def seeded_rows(rows: int, seed: int = 0):
    """Spliced 7 x 257 inputs and 40 labels that are a fixed function of
    the center frame."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 7 * 257)).astype(np.float32)
    proj = rng.normal(size=(257, 40)) / np.sqrt(257)
    y = 1.5 * np.tanh(x[:, 3 * 257:4 * 257] @ proj)
    return torch.from_numpy(x), torch.from_numpy(y.astype(np.float32))


def run_step(dtype: torch.dtype, wave: bool, rows: int) -> dict:
    """One SEGAN train step in ``dtype`` (weights drawn in f32 and cast):
    its losses, gradients and post-step parameters as f64 tensors."""
    args = train_cli.build_parser().parse_args(
        SEGAN_FLAGS + (["--g_type=wave"] if wave else []))
    trainer = train_cli.build_trainer(args, torch.device("cpu"),
                                      torch.float32)
    trainer.generator.to(dtype)
    trainer.discriminator.to(dtype)
    x, y = (t.to(dtype) for t in seeded_rows(rows))
    # the nets' own draws (z in init_state is zeros) take this dtype
    draw = segan_models.draw_normal
    segan_training.draw_normal = segan_models.draw_normal = (
        lambda source, shape, device: None if source is None
        else draw(source, shape, device).to(dtype))
    try:
        state = trainer.init_state(x)
        for i, net in enumerate((state.g, state.d)):
            moments_off_zero(net, 71 + i)
        trainer.grad_log = []
        draws = torch.Generator().manual_seed(11)
        metrics = trainer.train_step(
            state, x, y, HP,
            lambda shape: torch.randn(shape, generator=draws))
    finally:
        segan_training.draw_normal = segan_models.draw_normal = draw
    grads = {f"{i}:{tag}:{k}": g.double()
             for i, (tag, gs) in enumerate(trainer.grad_log)
             for k, g in gs.items()}
    params = {f"{name}.{k}": p.detach().double()
              for name, net in (("g", state.g), ("d", state.d))
              for k, p in net.params().items()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "params": params}


def rel(got: dict, want: dict) -> dict:
    return {k: float((got[k] - v).abs().max() / v.abs().max().clamp_min(
        1e-30)) for k, v in want.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.tools."
                                "step_conditioning")
    p.add_argument("--wave", action="store_true",
                   help="the WaveNet-style G (--g_type=wave)")
    p.add_argument("--rows", type=int, default=256)
    args = p.parse_args(argv)
    f32 = run_step(torch.float32, args.wave, args.rows)
    f64 = run_step(torch.float64, args.wave, args.rows)
    grads, params = rel(f32["grads"], f64["grads"]), rel(f32["params"],
                                                         f64["params"])

    def worst(errs):
        return dict(sorted(errs.items(), key=lambda kv: -kv[1])[:4])

    print(json.dumps({
        "generator": "wave" if args.wave else "ae", "rows": args.rows,
        "device": "cpu", "metrics_rel": {
            k: abs(v - f64["metrics"][k]) / abs(f64["metrics"][k])
            for k, v in f32["metrics"].items()},
        "grad_rel_max": max(grads.values()), "grad_worst": worst(grads),
        "post_step_param_rel_max": max(params.values()),
        "post_step_param_worst": worst(params)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
