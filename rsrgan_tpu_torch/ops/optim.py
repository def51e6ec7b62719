"""The fused optimizer update of ``csrc/optim.cu`` on the Python side: the
chunk table, the ctypes parameter block, the library and the launches.

``NetState.apply_gradients`` (``training/state.py``) takes this path for
every state on the card but a tensor-parallel one: the per-tensor clip,
SGD / Adam / RMSProp, the step and the EMA shadow in one launch for the
clip's partial norms (and Adam's step count) and one for the rest, where
the plain version issues one PyTorch kernel per leaf and operation. Its
parameters, moments and shadow must be contiguous f32 tensors on one card
and its gradients f32 tensors there (a strided gradient is copied to its
leaf's order first); anything else raises rather than falling back.

A ``FusedUpdate`` holds one net's tables on the card: a ``Leaf`` record
per parameter (pointers to it, its moments and its shadow; its size; its
first chunk and its number of chunks) and the chunk table, one
``(leaf, first element)`` pair per block of ``CHUNK`` elements, leaf by
leaf in the state's order. The leaves go in groups of ``SLOTS``, a launch
pair a group (every net of the benchmark is one group). The tables are
built here and copied to the card in one copy when the update is made;
``NetState`` makes a new one only when a tensor's storage changes (a
checkpoint load, ``parallel.replicate``). The gradients, new tensors
every step, go by value in the launch's parameter block, so a
steady-state update copies nothing to the card and never waits for its
queue. Every launch is counted through ``spans.count_launch`` on
``FusedUpdate``: by ``"<kind> leaves=<n>"`` and by route, ``sumsq`` or
``update``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.ops import _build

CHUNK = 4096   # elements a block: kChunk of csrc/optim.cu
SLOTS = 64     # gradients a launch: kSlots of csrc/optim.cu
KINDS = {"sgd": 0, "adam": 1, "rmsprop": 2}
ROUTES = ("sumsq", "update")   # the kernel of a launch's ``which``


class Leaf(ctypes.Structure):
    """``Leaf`` of csrc/optim.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("p", "mu", "nu", "e")]
                + [("numel", ctypes.c_longlong), ("first", ctypes.c_int),
                   ("chunks", ctypes.c_int)])


class Args(ctypes.Structure):
    """``Args`` of csrc/optim.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "leaves", "chunks", "partials", "norms", "count")]
        + [(n, ctypes.c_float) for n in (
            "lr", "ema_c", "max_norm", "b1", "c1", "b2", "c2", "eps")]
        + [(n, ctypes.c_int) for n in ("n_leaves", "n_chunks", "clip",
                                       "kind", "tick")])


Slots = ctypes.c_void_p * SLOTS


def block_bytes() -> int:
    """Bytes of a launch's parameter block (``Block`` of csrc/optim.cu):
    the arguments and ``SLOTS`` gradient pointers."""
    return ctypes.sizeof(Args) + ctypes.sizeof(Slots)


def chunk_table(numels: Sequence[int], chunk: int = CHUNK
                ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """The blocks of an update over leaves of ``numels`` elements: the
    chunks, ``(leaf, first element)`` in leaf order and then element
    order, each ``chunk`` elements but a leaf's last; and each leaf's
    ``(first chunk, number of chunks)``."""
    chunks, spans_ = [], []
    for leaf, n in enumerate(numels):
        spans_.append((len(chunks), -(-n // chunk)))
        chunks += [(leaf, start) for start in range(0, n, chunk)]
    return chunks, spans_


def library() -> ctypes.CDLL:
    lib = _build.load_library("optim")
    if lib.optim_launch.argtypes is None:
        lib.optim_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.optim_launch.restype = ctypes.c_int
        lib.optim_sizes.argtypes = [ctypes.c_int]
        lib.optim_sizes.restype = ctypes.c_int
        lib.optim_error_string.argtypes = [ctypes.c_int]
        lib.optim_error_string.restype = ctypes.c_char_p
        for which, (name, size) in enumerate((
                ("Leaf", ctypes.sizeof(Leaf)), ("Args", ctypes.sizeof(Args)),
                ("Block", block_bytes()))):
            if lib.optim_sizes(which) != size:
                raise RuntimeError(f"{name} does not match csrc/optim.cu")
    return lib


def launch(which: int, args: Args, grads: ctypes.Array,
           device: torch.device) -> None:
    """Launch ``sumsq_kernel`` (``which`` 0) or ``update_kernel`` (1) on
    the current stream of ``device``; raises RuntimeError on a refused
    launch."""
    lib = library()
    err = lib.optim_launch(which, ctypes.addressof(args),
                           ctypes.addressof(grads), device.index,
                           torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"optim_launch({which}) failed for {args.n_leaves} leaves: "
            f"CUDA error {err} ({lib.optim_error_string(err).decode()})")


class FusedUpdate:
    """One net's update through csrc/optim.cu: the leaf and chunk tables
    on the card, the scratch of the partial norms, and a parameter block
    a group of ``SLOTS`` leaves, whose gradient slots each update fills.

    ``leaves``: ``{name: (parameter, mu or None, nu or None, shadow)}`` in
    the state's order; ``kind`` and ``hyper`` (b1, b2, eps of Adam; decay,
    eps of RMSProp) the transform. Raises ValueError where a tensor is not
    a contiguous f32 tensor on the first parameter's device, or a leaf has
    2^31 elements or more."""

    # every launch in this process (spans.count_launch)
    launches = 0
    launches_by_shape: Dict[str, int] = {}
    launches_by_route: Dict[str, int] = {}

    def __init__(self, leaves: Dict[str, tuple], kind: str, hyper: dict):
        device = next(iter(leaves.values()))[0].device
        for name, leaf in leaves.items():
            if leaf[0].numel() >= 2 ** 31:
                raise ValueError(f"{name}: {leaf[0].numel()} elements; the "
                                 "fused update takes fewer than 2^31")
            for t in leaf:
                if t is not None and not (
                        t.dtype == torch.float32 and t.device == device
                        and t.is_contiguous()):
                    raise ValueError(
                        f"{name}: a {t.dtype} tensor on {t.device} "
                        f"(contiguous: {t.is_contiguous()}); the fused "
                        f"update takes contiguous float32 tensors on "
                        f"{device}")
        self.device, self.kind = device, kind
        rows = list(leaves.values())
        self.groups = [(at, min(at + SLOTS, len(rows)))
                       for at in range(0, len(rows), SLOTS)]
        records, chunk_rows, offsets = [], [], []
        for lo, hi in self.groups:
            numels = [leaf[0].numel() for leaf in rows[lo:hi]]
            chunks, per_leaf = chunk_table(numels)
            offsets.append(len(chunk_rows))
            records += [Leaf(*[0 if t is None else t.data_ptr()
                               for t in leaf], n, first, count)
                        for leaf, n, (first, count)
                        in zip(rows[lo:hi], numels, per_leaf)]
            chunk_rows += chunks
        records = (Leaf * len(rows))(*records)
        table = bytes(records) + torch.tensor(
            chunk_rows, dtype=torch.int32).numpy().tobytes()
        with spans.span("opt.upload"):
            # from pageable memory: waits for the card's queue, once per
            # set of storages
            if device.type != "cpu":
                spans.count("host_wait")
            self.tables = torch.frombuffer(bytearray(table),
                                           dtype=torch.uint8).to(device)
        self.partials = torch.empty(len(chunk_rows), dtype=torch.float64,
                                    device=device)
        # each leaf's gradient norm, as the clip read it (clip only)
        self.norms = torch.zeros(len(rows), dtype=torch.float32,
                                 device=device)
        if kind == "adam":
            b1, b2 = hyper["b1"], hyper["b2"]
        else:
            b1, b2 = 0.0, hyper.get("decay", 0.0)
        base = self.tables.data_ptr()
        self.args = []
        for (lo, hi), first, end in zip(self.groups, offsets,
                                        offsets[1:] + [len(chunk_rows)]):
            a = Args()
            a.leaves = base + lo * ctypes.sizeof(Leaf)
            a.chunks = base + ctypes.sizeof(records) + 8 * first
            a.partials = self.partials.data_ptr() + 8 * first
            a.norms = self.norms.data_ptr() + 4 * lo
            a.n_leaves, a.n_chunks, a.kind = hi - lo, end - first, KINDS[kind]
            # the scalars as PyTorch rounds a Python float operand to f32
            a.b1, a.c1, a.b2, a.c2 = b1, 1.0 - b1, b2, 1.0 - b2
            a.eps = hyper.get("eps", 0.0)
            self.args.append(a)
        self.slots = [Slots() for _ in self.groups]
        self.held: Optional[List[torch.Tensor]] = None

    def take_grads(self, grads: List[torch.Tensor]) -> None:
        """Fill the gradient slots from ``grads`` (in the leaves' order);
        raises ValueError where one is not an f32 tensor on the card. A
        strided gradient (a convolution kernel's: PyTorch's ``[out, in,
        k]`` seen in flax's ``[k, in, out]`` order) is copied into its
        leaf's element order first, one copy kernel; the slots' tensors
        are held until ``apply`` has launched."""
        for i, g in enumerate(grads):
            if g.dtype != torch.float32 or g.device != self.device:
                raise ValueError(
                    f"gradient {i}: a {g.dtype} tensor on {g.device}; the "
                    f"fused update takes float32 gradients on {self.device}")
        self.held = [g if g.is_contiguous() else g.contiguous()
                     for g in grads]
        for (lo, hi), slots in zip(self.groups, self.slots):
            for i, g in enumerate(self.held[lo:hi]):
                slots[i] = g.data_ptr()

    def apply(self, params: List[torch.Tensor],
              count: Optional[torch.Tensor], lr: float, ema_decay: float,
              max_norm: Optional[float]) -> None:
        """One update of ``params`` (the leaves' parameters) from the
        gradients of the last ``take_grads``. ``count``: Adam's step count,
        an int32 [] tensor on the card that the update increments there;
        None for SGD and RMSProp."""
        adam = self.kind == "adam"
        if adam and (count is None or count.dtype != torch.int32
                     or count.device != self.device):
            raise ValueError(f"Adam's count must be an int32 tensor on "
                             f"{self.device}")
        for group, (a, slots) in enumerate(zip(self.args, self.slots)):
            a.lr, a.ema_c = lr, 1.0 - ema_decay
            a.clip = max_norm is not None
            a.max_norm = 0.0 if max_norm is None else max_norm
            a.count = count.data_ptr() if adam else None
            a.tick = adam and group == 0
            if a.clip or a.tick:
                with spans.span("opt.clip"):
                    self._launch(0, a, slots)
            with spans.span("opt.update"):
                self._launch(1, a, slots)
        for p in params:
            # as an in-place PyTorch operation raises it
            torch.autograd.graph.increment_version(p)
        self.held = None

    def _launch(self, which: int, a: Args, slots: ctypes.Array) -> None:
        launch(which, a, slots, self.device)
        spans.count_launch(FusedUpdate, f"{self.kind} leaves={a.n_leaves}",
                           ROUTES[which])
