"""The yardstick's arithmetic: the card's peaks, the least time of a
kernel launch from its shapes (copied from ``chip_smoke.py``'s
``bound``, ``true_steps``, ``wavefront_bound`` and ``bwd_bound``), and the
model FLOPs of a training iteration or a decode at true frames.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit. A
launch's bound is the larger of its operations over the peak rate of
their type and its bytes over the memory rate; each input stream is read
once at the true row-steps only (a masked step needs no input) and each
output written once in full.
"""

from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype_name: str) -> dict:
    """The least time the card could take: the larger of operations over
    the peak rate of their type and bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def true_steps(lengths: Sequence[int], T_: int) -> int:
    return int(sum(min(int(n), T_) for n in lengths))


def wavefront_bound(L_, U_, P_, B_, T_, lengths, dtype_name, train,
                    residual=True) -> dict:
    """K4: per true row-step and layer, h·W_h (and in·W_x above layer 1)
    and m·proj. Bytes: weights, xw1 at the true row-steps, lengths, with
    the residual wiring (res_lstm_l) x at every row (the tap of a masked
    row is x itself); out: the top tap (decode) or the saved streams
    (train)."""
    G_, wb = 4 * U_, 2 if dtype_name == "bfloat16" else 4
    n = true_steps(lengths, T_)
    flops = n * (L_ * 2 * P_ * G_ + (L_ - 1) * 2 * P_ * G_ + L_ * 2 * U_ * P_)
    nbytes = (((2 * L_ - 1) * P_ * G_ + L_ * U_ * P_) * wb
              + L_ * (G_ + 3 * U_) * 4 + n * G_ * wb + B_ * 4
              + (T_ * B_ * P_ * 4 if residual else 0))
    if train:
        nbytes += L_ * T_ * B_ * ((2 * P_ + U_) * 4 + G_ * wb)
    else:
        nbytes += T_ * B_ * P_ * 4
    return bound(flops, nbytes, dtype_name)


def bwd_bound(U_, P_, B_, T_, lengths, dtype_name, acc) -> dict:
    """K2: per true row-step dh_total·projᵀ and dgates·W_hᵀ; K3 adds the
    weight-gradient products h(t-1)ᵀ·dgates and mᵀ·dh, so its bound
    covers the walk and the reduction together. Bytes: weights,
    peepholes, lengths, and acts, dout, c_hist (K3: h_hist) at the true
    row-steps; dxw (K2: m, dh; K3: the weight gradients) written."""
    G_, wb = 4 * U_, 2 if dtype_name == "bfloat16" else 4
    n = true_steps(lengths, T_)
    flops = n * (2 * P_ * U_ + 2 * G_ * P_)
    nbytes = ((P_ * G_ + U_ * P_) * wb + 3 * U_ * 4 + B_ * 4
              + n * (G_ * wb + P_ * 4 + U_ * 4)   # acts, dout, c_hist
              + T_ * B_ * G_ * wb)                # dxw
    if acc:
        flops += n * (2 * P_ * G_ + 2 * U_ * P_)
        nbytes += n * P_ * 4 + (P_ * G_ + U_ * P_ + G_ + 3 * U_) * 4
    else:
        nbytes += T_ * B_ * (U_ + P_) * wb        # m, dh
    return bound(flops, nbytes, dtype_name)


def parse_key(key: str) -> Dict[str, int]:
    """A launch counter's shape key (``"U=760,P=257,B=16"``, the K4 keys
    with ``L`` and ``residual`` too) as ints."""
    return {k: int(v) for k, v in (kv.split("=") for kv in key.split(","))}


def row_lengths(rows: int, lengths: Sequence[int]):
    """The true lengths of a launch of ``rows`` rows in an iteration on a
    batch of ``lengths``: the batch itself, or D's real and fake halves
    (2B rows); None for any other row count."""
    lengths = list(lengths)
    if rows == len(lengths):
        return lengths
    if rows == 2 * len(lengths):
        return lengths + lengths
    return None


# -- model FLOPs ------------------------------------------------------------
#
# A product of an [*, a] operand with an [a, b] weight costs 2ab a row;
# its backward costs 2ab for the weight gradient and 2ab more for the
# operand's gradient where the operand needs one. Elementwise work is not
# counted. Counts are per true frame (a masked row-step needs no product).

def lstm_products(d_in: int, U: int, P: int) -> Dict[str, int]:
    """FLOPs a row-step of one peephole LSTM layer with a projection:
    the input product, the recurrent product and the projection."""
    return {"x": 2 * d_in * 4 * U, "h": 2 * P * 4 * U, "proj": 2 * U * P}


def net_flops(layers, dense_in: int, dense_out: int) -> Dict[str, int]:
    """Forward FLOPs a row of a stack (``layers``: (d_in, U, P) each)
    topped by a dense layer, and the part of it that the first layer's
    input product takes (whose operand gradient a net on data skips)."""
    prods = [lstm_products(*layer) for layer in layers]
    fwd = sum(sum(p.values()) for p in prods) + 2 * dense_in * dense_out
    return {"fwd": fwd, "first_x": prods[0]["x"]}


def g_flops(g: dict) -> Dict[str, int]:
    P = g["num_proj"]
    layers = [(g["input_dim"] if k == 0 else P, g["cell_size"], P)
              for k in range(g["num_layers"])]
    return net_flops(layers, P, g["output_dim"])


def d_flops(d: dict) -> Dict[str, int]:
    P = d["num_proj"]
    layers = [(d["input_dim"] if k == 0 else P, d["cell_size"], P)
              for k in range(d["num_layers"])]
    return net_flops(layers, P, 1)


def backward(f: Dict[str, int], input_grad: bool) -> int:
    """Backward FLOPs a row: every weight gradient, and every operand
    gradient but the first layer's input's unless ``input_grad``."""
    return 2 * f["fwd"] - (0 if input_grad else f["first_x"])


def gan_iteration_flops(cfg: dict) -> int:
    """FLOPs a true frame of one LSGAN iteration (1 D step and 2 G steps
    on one batch, the first G step sharing the D step's G forward):

    * D step: G forward; D forward and backward on 2B rows (real and
      fake), no input gradient;
    * each G step: D forward and backward with the input gradient, G
      backward; the second also its own G forward.
    """
    g, d = g_flops(cfg["generator"]), d_flops(cfg["discriminator"])
    hp = cfg["hparams"]
    d_step = 2 * (d["fwd"] + backward(d, False))
    g_step = d["fwd"] + backward(d, True) + backward(g, False)
    g_fwds = 1 + max(0, hp["gen_updates"] - 1)
    return (g_fwds * g["fwd"] + hp["disc_updates"] * d_step
            + hp["gen_updates"] * g_step)


def mse_iteration_flops(cfg: dict) -> int:
    """FLOPs a true frame of one MSE step: G forward and backward."""
    g = g_flops(cfg["generator"])
    return g["fwd"] + backward(g, False)


def decode_flops(cfg: dict) -> int:
    """FLOPs a true frame of G's forward."""
    return g_flops(cfg["generator"])["fwd"]
