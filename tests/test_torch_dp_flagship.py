"""The flagship LSGAN in a data-parallel world of four gloo ranks on the
CPU, 2 rows each (``--num_gpu=4``'s layout at narrow widths, f32): after
one iteration (1 D and 2 G updates) every rank holds the same state bit
for bit, rank 0 matches the plain reference's step on all 8 rows at the
rates x 4 (``benchmark/reference/res_lstm.py``) within the f32
tolerances of ``tests/test_pallas_lstm.py:41-44`` (forwards, here the
losses, 1e-5; gradients 2e-4: G's Adam first moment, D's SGD step over
its rate), and each update is one all-reduce of its gradients and
metrics (``comm.all_reduce`` spans, ``comm.bytes``)."""

import importlib.util
import os
import pickle

import torch
import torch_dp_flagship_ranks as ranks

from rsrgan_tpu_torch.parallel import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, ROWS, T = 4, 2, 11
LR_G, LR_D = 8e-5, 3e-4


def reference():
    """The benchmark's plain reference, loaded from its file."""
    path = os.path.join(ROOT, "benchmark", "reference", "res_lstm.py")
    spec = importlib.util.spec_from_file_location("res_lstm_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config():
    g = {"type": "res_lstm_l", "input_dim": ranks.IN,
         "output_dim": ranks.OUT, "num_layers": 4, "cell_size": ranks.GU,
         "num_proj": ranks.IN, "peepholes": True, "forget_bias": 1.0,
         "residual": "layer"}
    d = {"type": "lstm", "input_dim": ranks.OUT, "num_layers": 2,
         "cell_size": ranks.DU, "num_proj": ranks.OUT, "peepholes": True,
         "forget_bias": 1.0, "noise_std": 0.05}
    hp = {"trainer": "gan", "disc_updates": 1, "gen_updates": 2,
          "d_optimizer": "sgd", "d_lr": LR_D * WORLD, "g_optimizer": "adam",
          "g_lr": LR_G * WORLD, "adam_b1": 0.9, "adam_b2": 0.999,
          "adam_eps": 1e-8, "mse_weight": 10.0, "l2_scale": 0.0,
          "max_grad_norm": 15.0, "ema_decay": 0.9999, "d_real": 1.0,
          "d_fake": 0.0}
    return {"generator": g, "discriminator": d, "hparams": hp}


def weights(ref, cfg):
    gen = torch.Generator().manual_seed(11)
    out = {}
    for net, shapes in (("g", ref.g_shapes(cfg["generator"])),
                        ("d", ref.d_shapes(cfg["discriminator"]))):
        out[net] = {k: (torch.zeros(s) if k.endswith("bias") else
                        0.05 * torch.randn(s, generator=gen))
                    for k, s in shapes.items()}
    return out


def test_four_ranks_hold_one_state_and_match_the_reference(tmp_path):
    ref, cfg = reference(), config()
    init = weights(ref, cfg)
    gen = torch.Generator().manual_seed(5)
    rows = WORLD * ROWS
    lens = torch.tensor([11, 7, 9, 11, 5, 10, 8, 11])
    x = torch.randn(rows, T, ranks.IN, generator=gen)
    y = torch.randn(rows, T, ranks.OUT, generator=gen)
    mask = (torch.arange(T)[None, :] < lens[:, None])[..., None]
    x, y = x * mask, y * mask
    hp = {"g_lr": LR_G * WORLD, "d_lr": LR_D * WORLD, "mse_lambda": 10.0,
          "disc_noise_std": 0.05, "d_real": 1.0, "d_fake": 0.0}
    case = tmp_path / "case.pkl"
    with open(case, "wb") as f:
        pickle.dump({"weights": init, "batch": (x, y, lens), "hp": hp,
                     "noise": 3}, f)
    assert launch(ranks.step_rank, WORLD, args=(str(case), str(tmp_path)),
                  timeout=240) == 0
    got = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    for other in got[1:]:
        for part in ("g", "d", "mu"):
            assert all(torch.equal(got[0][part][k], other[part][k])
                       for k in got[0][part]), part
        assert other["metrics"] == got[0]["metrics"]

    want = ref.train(cfg, init, [(x, y, lens)], 3, "cpu")
    mine = got[0]
    for k, v in mine["metrics"].items():
        assert abs(v - want["losses"][0][k]) <= 1e-5 * max(
            1.0, abs(want["losses"][0][k])), k
    for k, mu in mine["mu"].items():
        assert float((mu - want["after"]["g"]["mu"][k]).abs().max()) <= \
            2e-4, k
    for k, p in mine["d"].items():
        step = (p - init["d"][k]) / (LR_D * WORLD)
        want_step = (want["after"]["d"]["params"][k] - init["d"][k]) / (
            LR_D * WORLD)
        assert float((step - want_step).abs().max()) <= 2e-4, k

    n_d = sum(v.numel() for v in init["d"].values())
    n_g = sum(v.numel() for v in init["g"].values())
    for r in got:
        assert r["all_reduces"] == 3
        # f32 buffers: D's gradients and its 3 losses, then twice G's
        # gradients and its 4 losses
        assert r["bytes"] == 4 * ((n_d + 3) + 2 * (n_g + 4))
