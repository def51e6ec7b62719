"""Recognition proxy: score enhanced features on the WER axis
(counterpart of ``tools/proxy_asr.py``).

The synthetic corpus's content is chosen by the simulation itself
(``sim/synthwav.py`` ``make_phone_like_wav``): utterances are sequences
of units from a fixed 16-way pseudo-phone inventory, with frame-level
alignments recorded at synthesis time. This tool stands in for a
downstream recognizer's WER:

1. train a small frame classifier (spliced-context MLP, Adam) on CLEAN
   features against the alignments,
2. evaluate it on each system's features ({noisy, MSE-enhanced,
   GAN-enhanced}) over the same utterances,
3. report FER (frame error rate) and SER (segment error rate: one
   majority vote per true unit segment).

The unspliced frame table and a ``[N, 2c+1]`` table of clamped splice
indices live on the device; each step sends only a ``[batch]`` frame
selection, and the spliced batch is gathered there. The batch order
comes from ``np.random.default_rng(seed + 1)``, as in the JAX tool; the
initial weights from a ``torch.Generator`` (``load_params`` starts from
another implementation's). f32, no TF32 (``device.set_precision``).

Usage (``--device`` defaults to ``cuda`` and raises without a card)::

    python -m rsrgan_tpu_torch.tools.proxy_asr --train_scp clean_tr.scp \\
        --ali_scp ali.scp --eval noisy=corrupted_cv.scp \\
        --eval mse=mse/feats.scp --eval gan=gan/feats.scp \\
        --holdout_scp clean_cv.scp --out proxy.json

All feature scps must be in the same domain (raw LPS: the decode CLI's
denormalized output matches the clean extraction). Normalization is
computed from the classifier's training set and applied to every system.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from rsrgan_tpu_torch.device import resolve_device, set_precision
from rsrgan_tpu_torch.data.kaldi_ark import ScpReader
from rsrgan_tpu_torch.training.state import Adam

PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def read_alignments(ali_scp: str) -> dict:
    out = {}
    with open(ali_scp) as f:
        for line in f:
            utt, path = line.split()
            out[utt] = np.load(path)
    return out


def load_corpus(scp: ScpReader, ali: dict, context: int,
                utt_stride: int = 1):
    """-> (base [N, D] f32, idx [N, 2c+1] i32, y [N] i32, per-utt slices).

    base is the unspliced frame table; idx[t] are the edge-clamped global
    row indices whose concatenation is the spliced frame t
    (data/splice.py semantics). Feats/alignment lengths may drift by an
    edge frame or two (decode trims to true length); tolerate <=2, fail
    beyond. ``utt_stride`` keeps every k-th utterance (whole utterances,
    so splice windows stay intact), to bound the train table."""
    bases, idxs, ys, slices, pos = [], [], [], {}, 0
    offsets = np.arange(-context, context + 1)
    for i, utt in enumerate(scp.utt_ids):
        if i % utt_stride:
            continue
        if utt not in ali:
            continue
        feats = scp.read_utt(utt)
        labels = ali[utt]
        n = min(feats.shape[0], len(labels))
        if abs(feats.shape[0] - len(labels)) > 2:
            raise ValueError(
                f"{utt}: {feats.shape[0]} feature frames vs "
                f"{len(labels)} alignment frames — wrong ali.scp?")
        bases.append(np.asarray(feats[:n], np.float32))
        t = np.arange(n)[:, None]
        idxs.append((np.clip(t + offsets, 0, n - 1) + pos).astype(np.int32))
        ys.append(labels[:n].astype(np.int32))
        slices[utt] = (pos, pos + n)
        pos += n
    if not bases:
        raise ValueError("no utterances overlap between the scp and ali.scp")
    return (np.concatenate(bases), np.concatenate(idxs),
            np.concatenate(ys), slices)


class ProxyClassifier:
    """Small MLP frame classifier over gathered splice windows: three
    layers, ReLU, softmax cross-entropy, Adam (optax ``adam(lr)``'s
    math, ``training/state.py``)."""

    def __init__(self, in_dim: int, num_classes: int, hidden: int,
                 lr: float, seed: int, device="cuda"):
        self.device = resolve_device(str(device))
        self.lr = float(lr)
        gen = torch.Generator().manual_seed(seed)

        def normal(*shape, scale):
            return torch.randn(shape, generator=gen) * scale

        self.load_params({
            "w1": normal(in_dim, hidden, scale=np.sqrt(2.0 / in_dim)),
            "b1": torch.zeros(hidden),
            "w2": normal(hidden, hidden, scale=np.sqrt(2.0 / hidden)),
            "b2": torch.zeros(hidden),
            "w3": normal(hidden, num_classes, scale=0.01),
            "b3": torch.zeros(num_classes),
        })

    def load_params(self, tree: Dict[str, object]) -> None:
        """Take ``{"w1", "b1", ..., "b3"}`` (numpy arrays or tensors) as
        the weights, and start Adam afresh from them."""
        def tensor(v):
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, np.float32))
            return v.to(self.device, torch.float32)

        self.params = {k: tensor(tree[k]) for k in PARAM_NAMES}
        self.tx = Adam()
        self.opt_state = self.tx.init(self.params)

    def numpy_params(self) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.params.items()}

    @staticmethod
    def assemble(base, idx, mean, std, sel):
        """The spliced, normalized batch ``[b, (2c+1) D]`` of frames
        ``sel``, gathered on the device."""
        xb = base[idx[sel].long()]                 # [b, 2c+1, D]
        return (xb.reshape(sel.shape[0], -1) - mean) / std

    def logits(self, xb: torch.Tensor, params=None) -> torch.Tensor:
        p = self.params if params is None else params
        h = torch.relu(xb @ p["w1"] + p["b1"])
        h = torch.relu(h @ p["w2"] + p["b2"])
        return h @ p["w3"] + p["b3"]

    def gradients(self, base, idx, mean, std, sel, y):
        """(mean cross-entropy on frames ``sel``, its gradient by
        parameter name)."""
        xb = self.assemble(base, idx, mean, std, sel)
        params = {k: v.detach().requires_grad_() for k, v in
                  self.params.items()}
        loss = F.cross_entropy(self.logits(xb, params), y[sel].long())
        grads = torch.autograd.grad(loss, [params[k] for k in PARAM_NAMES])
        return loss.detach(), dict(zip(PARAM_NAMES, grads))

    def train_step(self, base, idx, mean, std, sel, y) -> torch.Tensor:
        """One Adam step on frames ``sel``; returns the loss (a device
        scalar, no host sync)."""
        loss, grads = self.gradients(base, idx, mean, std, sel, y)
        with torch.no_grad():
            updates = self.tx.update(grads, self.opt_state)
            self.params = {k: self.params[k] - self.lr * updates[k]
                           for k in PARAM_NAMES}
        return loss

    def fit(self, base_d, idx_d, y_d, n: int, epochs: int, batch: int,
            seed: int, mean_d, std_d):
        rng = np.random.default_rng(seed)
        steps_per_epoch = max(1, n // batch)
        for epoch in range(epochs):
            order = rng.permutation(n)
            losses = []
            for s in range(steps_per_epoch):
                sel = torch.from_numpy(
                    order[s * batch:(s + 1) * batch]).to(self.device)
                losses.append(self.train_step(base_d, idx_d, mean_d, std_d,
                                              sel, y_d))
            xent = float(torch.stack(losses).mean())
            print(f"proxy classifier epoch {epoch + 1}/{epochs}: "
                  f"xent {xent:.4f}", flush=True)

    @torch.no_grad()
    def predict_all(self, base_d, idx_d, n: int, batch: int, mean_d,
                    std_d) -> np.ndarray:
        outs = []
        for s in range(0, n, batch):
            sel = torch.arange(s, min(n, s + batch), device=self.device)
            outs.append(torch.argmax(self.logits(
                self.assemble(base_d, idx_d, mean_d, std_d, sel)), dim=-1))
        return torch.cat(outs).cpu().numpy()


def segment_error_rate(preds: np.ndarray, y: np.ndarray,
                       slices: dict) -> tuple:
    seg_err, seg_tot = 0, 0
    for utt, (lo, hi) in slices.items():
        labels, p = y[lo:hi], preds[lo:hi]
        bounds = np.flatnonzero(np.diff(labels)) + 1
        for a, b in zip(np.concatenate([[0], bounds]),
                        np.concatenate([bounds, [len(labels)]])):
            votes = np.bincount(p[a:b])
            seg_err += int(np.argmax(votes) != labels[a])
            seg_tot += 1
    return seg_err, seg_tot


def build_parser() -> argparse.ArgumentParser:
    """The JAX tool's flags (same names and defaults) plus --device."""
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.tools.proxy_asr")
    p.add_argument("--train_scp", required=True,
                   help="CLEAN features the classifier trains on")
    p.add_argument("--ali_scp", required=True,
                   help="frame alignments from make_sim_assets("
                        "alignments=True)")
    p.add_argument("--eval", action="append", default=[],
                   metavar="NAME=SCP", help="system to score (repeatable)")
    p.add_argument("--holdout_scp", default=None,
                   help="clean features of the EVAL utterances "
                        "(classifier sanity ceiling, reported as 'clean')")
    p.add_argument("--context", type=int, default=2,
                   help="splice context each side (input dim x(2c+1))")
    p.add_argument("--max_train_frames", type=int, default=2_500_000,
                   help="bound the train table via utterance striding")
    p.add_argument("--hidden", type=int, default=192)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write JSON here too")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train and score on; 'cuda' fails "
                        "when no GPU is present")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_precision()
    device = resolve_device(args.device)

    from rsrgan_tpu_torch.sim.synthwav import NUM_PHONES

    ali = read_alignments(args.ali_scp)
    tr_scp = ScpReader(args.train_scp)
    total = sum(len(ali[u]) for u in tr_scp.utt_ids if u in ali)
    stride = max(1, -(-total // args.max_train_frames))
    if stride > 1:
        print(f"proxy classifier: {total} frames available; keeping every "
              f"{stride}th utterance (--max_train_frames "
              f"{args.max_train_frames})", flush=True)
    base, idx, y, _ = load_corpus(tr_scp, ali, args.context,
                                  utt_stride=stride)
    n, d = base.shape
    splice_n = 2 * args.context + 1
    # per-dim stats of the base table, tiled across splice columns (each
    # spliced column is a base frame, so they share statistics)
    mean = np.tile(base.mean(axis=0), splice_n)[None, :]
    std = np.tile(base.std(axis=0) + 1e-5, splice_n)[None, :]
    print(f"proxy classifier: {n} train frames, {NUM_PHONES} classes, "
          f"input dim {d * splice_n}", flush=True)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    clf = ProxyClassifier(d * splice_n, NUM_PHONES, args.hidden, args.lr,
                          args.seed, device=device)
    base_d, idx_d, y_d = put(base), put(idx), put(y)
    mean_d, std_d = put(mean.astype(np.float32)), put(std.astype(np.float32))
    t0 = time.monotonic()
    clf.fit(base_d, idx_d, y_d, n, args.epochs, args.batch, args.seed + 1,
            mean_d, std_d)
    fit_secs = time.monotonic() - t0
    steps = args.epochs * max(1, n // args.batch)
    print(f"proxy classifier: {steps * min(args.batch, n) / fit_secs:,.0f} "
          f"train frames/s ({steps} steps in {fit_secs:.2f}s on {device})",
          flush=True)

    result = {"classes": NUM_PHONES, "context": args.context,
              "train_frames": int(n), "systems": {}}
    n_tr_eval = min(n, 200000)
    tr_preds = clf.predict_all(base_d, idx_d, n_tr_eval, args.batch,
                               mean_d, std_d)
    result["train_fer"] = round(float(np.mean(tr_preds != y[:n_tr_eval])),
                                4)
    del base_d, idx_d, y_d

    systems = []
    if args.holdout_scp:
        systems.append(("clean", args.holdout_scp))
    for spec in args.eval:
        name, scp_path = spec.split("=", 1)
        systems.append((name, scp_path))
    for name, scp_path in systems:
        b, ix, ye, slices = load_corpus(ScpReader(scp_path), ali,
                                        args.context)
        preds = clf.predict_all(put(b), put(ix), b.shape[0], args.batch,
                                mean_d, std_d)
        fer = float(np.mean(preds != ye))
        seg_err, seg_tot = segment_error_rate(preds, ye, slices)
        result["systems"][name] = {
            "fer": round(fer, 4),
            "ser": round(seg_err / max(seg_tot, 1), 4),
            "frames": int(len(ye)), "segments": seg_tot}
        print(f"proxy[{name}]: FER {fer:.4f} "
              f"SER {seg_err / max(seg_tot, 1):.4f}", flush=True)

    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
