"""The convolutions' yardstick: the least time of a 1-D convolution's
forward and of the backward parts a training step takes of it, from its
shape key, and the model FLOPs of a SEGAN iteration.

The keys are the program's (``rsrgan_tpu_torch.ops.modules.conv_key``,
counted in ``conv_calls`` by shape): ``in`` (C) and ``out`` (O) channels,
width ``k``, ``stride`` s, input length ``L``, ``rows`` B,
``transposed``, ``grad`` (recorded for a backward) and ``dx`` (the
backward computes the input's gradient); ``step_convs`` adds ``dw`` (it
computes the kernel's), which the training step decides. A convolution ("SAME") has ``ceil(L
/ s)`` output positions, each meeting ``k`` input positions; a
transposed one ``L * s``, and each of its ``L`` input positions meets
the whole kernel once. So the forward's operations are ``2 B n C k O``
with ``n`` the positions the kernel is applied at (the output's for a
convolution, the input's for a transposed one), and each gradient's are
the same. Bytes, f32, each read once and written once: the forward reads
x (``B C L``) and the kernel (``k C O``) and writes y (``B O Lout``); dx
reads dy and the kernel and writes dx; dw reads x and dy and writes the
kernel's gradient. Biases and the padding copy are not counted. Each
part is a launch of its own, and its bound is ``roofline.bound``'s at
the f32 peak (67 TFLOP/s outside the tensor cores; TF32 is off) and
3.35 TB/s.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.roofline import bound, parse_key

F32 = 4


def out_length(s: Dict[str, int]) -> int:
    """The output positions of a convolution of key ``s``."""
    if s["transposed"]:
        return s["L"] * s["stride"]
    return -(-s["L"] // s["stride"])


def conv_parts(s: Dict[str, int]) -> List[Tuple[str, float, float]]:
    """``(part, flops, bytes)`` of the forward of key ``s`` and of each
    gradient its backward computes (``dx``, ``dw``)."""
    B, C, O, k, L = s["rows"], s["in"], s["out"], s["k"], s["L"]
    n = L if s["transposed"] else out_length(s)
    flops = 2.0 * B * n * C * k * O
    x, w, y = B * C * L * F32, k * C * O * F32, B * O * out_length(s) * F32
    parts = [("fwd", flops, x + w + y)]
    if s["dx"]:
        parts.append(("dx", flops, y + w + x))
    if s["dw"]:
        parts.append(("dw", flops, x + y + w))
    return parts


def conv_bound_ms(key: str) -> float:
    """The least ms of one counted call of ``key``: its forward and the
    gradients its backward computes, each at its own bound."""
    return sum(bound(f, b, "float32")["bound_ms"]
               for _, f, b in conv_parts(parse_key(key)))


# -- SEGAN's step -----------------------------------------------------------

def _halve(length: int) -> int:
    return -(-length // 2)


def g_convs(g: dict) -> List[Dict[str, int]]:
    """The auto-encoder G's convolutions on one row, as keys (rows 1, no
    gradient flags): the encoder, then the decoder, each transposed layer
    on its input's length (the skip's it was cut to)."""
    width = g["input_dim"] * (g["left_context"] + 1 + g["right_context"])
    enc, k = list(g["enc_depths"]), g["kwidth"]
    out, lengths, c_in, L = [], [], 1, width
    for depth in enc:
        out.append(dict(rows=1, **{"in": c_in}, out=depth, k=k, stride=2,
                        L=L, transposed=0))
        L = _halve(L)
        lengths.append(L)
        c_in = depth
    c_in += enc[-1] if g["z_on"] else 0
    dec = enc[:-1][::-1] + [1]
    for i, depth in enumerate(dec):
        out.append(dict(rows=1, **{"in": c_in}, out=depth, k=k, stride=2,
                        L=lengths[-(i + 1)], transposed=1))
        c_in = 2 * depth
    return out


def d_convs(d: dict) -> List[Dict[str, int]]:
    """D's convolutions on one row of ``d["input_width"]``."""
    fmaps, k = list(d["num_fmaps"]), d["kwidth"]
    out, c_in, L = [], 1, d["input_width"]
    for f in fmaps:
        out.append(dict(rows=1, **{"in": c_in}, out=f, k=k, stride=2, L=L,
                        transposed=0))
        c_in, L = f, _halve(L)
    out.append(dict(rows=1, **{"in": c_in}, out=1, k=k, stride=1, L=L,
                    transposed=0))
    return out


def _net(convs: List[Dict[str, int]], dense: int) -> Dict[str, float]:
    """Forward FLOPs a row of a net of ``convs`` and a dense layer of
    ``dense`` FLOPs, and the first convolution's (whose input gradient a
    net on data skips)."""
    each = [conv_parts(dict(s, dx=0, dw=0))[0][1] for s in convs]
    return {"fwd": sum(each) + dense, "first": each[0]}


def step_convs(counts: Dict[str, int], cfg: dict) -> Dict[str, int]:
    """The program's counts of whole SEGAN iterations' convolutions
    (``conv_calls`` keys) with ``dw`` added to each key: whether the
    backward takes the kernel's gradient. The step decides that, not the
    call: each D step differentiates D's loss with respect to D's
    parameters, each G step G's loss with respect to G's alone, through
    D. So a G convolution recorded for a backward takes it, and of D's
    recorded calls the D steps' do (two a D step: the real rows and the
    fake) and the G steps' (one a G step) do not. In D's first layer
    ``dx`` tells them apart (its input is data in a D step, G's output in
    a G step); in D's other layers ``2 du`` of every ``2 du + gu`` calls
    take it (``du``, ``gu``: the D and G steps an iteration)."""
    hp = cfg["hparams"]
    du, gu = hp["disc_updates"], hp["gen_updates"]
    d_shapes = [(s["in"], s["out"], s["k"], s["stride"], s["L"])
                for s in d_convs(cfg["discriminator"])]
    out: Dict[str, int] = {}

    def add(s: Dict[str, int], dw: int, n: int) -> None:
        if n:
            key = ",".join(f"{k}={v}" for k, v in dict(s, dw=dw).items())
            out[key] = out.get(key, 0) + n

    for key, n in counts.items():
        s = parse_key(key)
        shape = (s["in"], s["out"], s["k"], s["stride"], s["L"])
        if not s["grad"] or shape not in d_shapes:
            add(s, s["grad"], n)
        elif shape == d_shapes[0]:
            add(s, 1 - s["dx"], n)
        else:
            calls = 2 * du + gu
            if n % calls:
                raise ValueError(f"{n} calls of {key} are not whole "
                                 f"iterations of {calls}")
            add(s, 1, n // calls * 2 * du)
            add(s, 0, n // calls * gu)
    return out


def segan_iteration_flops(cfg: dict) -> float:
    """Model FLOPs a frame (a row) of one SEGAN iteration, products only,
    each gradient costing its forward's FLOPs:

    * each D step: G forward; D forward on the real and on the fake rows,
      each with every weight gradient and every input gradient but the
      first layer's (its input is data);
    * each G step: G forward with every weight gradient and every input
      gradient but the first layer's; D forward with every input
      gradient (to reach G) and no weight gradient.
    """
    g, d, hp = cfg["generator"], cfg["discriminator"], cfg["hparams"]
    width = g["input_dim"] * (g["left_context"] + 1 + g["right_context"])
    gf = _net(g_convs(g), 2.0 * 2 * _halve(width) * g["output_dim"])
    n_d = len(d["num_fmaps"])
    last = d["input_width"]
    for _ in range(n_d):
        last = _halve(last)
    df = _net(d_convs(d), 2.0 * last)
    d_step = gf["fwd"] + 2 * (df["fwd"] + 2 * df["fwd"] - df["first"])
    g_step = (gf["fwd"] + 2 * gf["fwd"] - gf["first"]
              + df["fwd"] + df["fwd"])
    return hp["disc_updates"] * d_step + hp["gen_updates"] * g_step


# -- the convolutions' kernels in a trace -----------------------------------

# cuDNN's kernels of a convolution's forward and of its data and weight
# gradients, by the names the profiler gives them. A traced segan_b256
# run on an H100 (torch 2.11, CUDA 12.8) showed sm80_xmma_{fprop,dgrad,
# wgrad}_implicit_gemm_*_cudnn, cudnn::detail::dgrad_engine,
# wgrad_alg0_engine, implicit_convolve_sgemm,
# cudnn::cnn::dgrad2d_grouped_direct_kernel and cuDNN's layout and scale
# helpers (cudnn::engines_precompiled::*); cuBLAS's GEMMs of the dense
# layers (*_gemm_*_cublas, cutlass_*_sgemm_*, gemvx, splitKreduce) and
# the transposed kernels' flip stay out.
KERNELS = r"(?i)conv|cudnn|fprop|dgrad|wgrad|winograd|fft"
