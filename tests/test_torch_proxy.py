"""The port's recognition proxy (rsrgan_tpu_torch/tools/proxy_asr.py)
against the JAX tool (tools/proxy_asr.py): logits and one Adam step from
JAX's initial weights, one epoch of fit under the same numpy order, the
segment error rate, the corpus loader, and main() on the separable
corpus of tests/test_proxy.py with that test's gates and JSON keys."""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu_torch.data import ArkWriter, ScpReader
from rsrgan_tpu_torch.sim.synthwav import NUM_PHONES
from rsrgan_tpu_torch.tools import proxy_asr

jax_proxy = importlib.import_module("tools.proxy_asr")

CONTEXT, HIDDEN, BATCH = 1, 32, 128
TOL = 2e-4   # the JAX ladder's gradient tolerance (post-step params)


def write_corpus(tmp_path, snr):
    """tests/test_proxy.py's synthetic features: class codes + noise at
    the given separability; returns (scp_path, ali_scp)."""
    rng = np.random.default_rng(7)
    d = 20
    codes = rng.normal(size=(NUM_PHONES, d)).astype(np.float32)
    ark = str(tmp_path / f"feats_{snr}.ark")
    scp = str(tmp_path / f"feats_{snr}.scp")
    ali_dir = tmp_path / "ali"
    ali_dir.mkdir(exist_ok=True)
    ali_scp = str(tmp_path / "ali.scp")
    w = ArkWriter(scp)
    with open(ali_scp, "w") as af:
        for i in range(40):
            n = int(rng.integers(60, 100))
            labels = rng.integers(0, NUM_PHONES, size=n)
            labels = np.repeat(labels, 5)[:n].astype(np.int32)
            feats = (codes[labels] * snr
                     + rng.normal(size=(n, d))).astype(np.float32)
            utt = f"u{i}"
            w.write_next_utt(ark, utt, feats)
            path = str(ali_dir / f"{utt}_{snr}.npy")
            np.save(path, labels)
            af.write(f"{utt} {path}\n")
    w.close()
    return scp, ali_scp


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """The clean corpus as both tools load it, its normalization, and a
    JAX classifier (its initial weights)."""
    tmp = tmp_path_factory.mktemp("proxy")
    scp, ali_scp = write_corpus(tmp, snr=4.0)
    ali = proxy_asr.read_alignments(ali_scp)
    base, idx, y, slices = proxy_asr.load_corpus(ScpReader(scp), ali,
                                                 CONTEXT)
    jbase, jidx, jy, jslices = jax_proxy.load_corpus(
        jax_proxy.ScpReader(scp), jax_proxy.read_alignments(ali_scp),
        CONTEXT)
    for a, b in ((base, jbase), (idx, jidx), (y, jy)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert slices == jslices
    splice = 2 * CONTEXT + 1
    mean = np.tile(base.mean(axis=0), splice)[None, :].astype(np.float32)
    std = np.tile(base.std(axis=0) + 1e-5, splice)[None, :].astype(
        np.float32)
    jclf = jax_proxy.ProxyClassifier(base.shape[1] * splice, NUM_PHONES,
                                     HIDDEN, 3e-3, seed=0)
    return dict(base=base, idx=idx, y=y, mean=mean, std=std, jclf=jclf,
                scp=scp, ali_scp=ali_scp, tmp=tmp)


def port_classifier(t):
    clf = proxy_asr.ProxyClassifier(t["base"].shape[1] * (2 * CONTEXT + 1),
                                     NUM_PHONES, HIDDEN, 3e-3, seed=0,
                                     device="cpu")
    clf.load_params(jax.tree.map(np.asarray, t["jclf"].params))
    return clf


def tensors(t):
    return [torch.from_numpy(np.ascontiguousarray(t[k]))
            for k in ("base", "idx", "y", "mean", "std")]


def jax_arrays(t):
    return [jnp.asarray(a) for a in (t["base"], t["idx"].T, t["y"],
                                     t["mean"], t["std"])]


def max_param_diff(clf, params):
    return max(float(np.abs(clf.numpy_params()[k]
                            - np.asarray(params[k])).max())
               for k in proxy_asr.PARAM_NAMES)


def test_logits_from_jax_weights(table):
    clf = port_classifier(table)
    base, idx, _, mean, std = tensors(table)
    sel = np.arange(0, 300, 2)
    got = clf.logits(clf.assemble(base, idx, mean, std,
                                  torch.from_numpy(sel))).numpy()
    # the JAX tool's gather (transposed index table) and layers
    p = table["jclf"].params
    jb, jidx, _, jm, js = jax_arrays(table)
    xb = jnp.swapaxes(jb[jidx[:, sel]], 0, 1).reshape(len(sel), -1)
    xb = (xb - jm) / js
    h = jax.nn.relu(xb @ p["w1"] + p["b1"])
    h = jax.nn.relu(h @ p["w2"] + p["b2"])
    want = np.asarray(h @ p["w3"] + p["b3"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_one_adam_step_matches_jax(table):
    clf = port_classifier(table)
    sel = np.random.default_rng(5).permutation(len(table["y"]))[:BATCH]
    base, idx, y, mean, std = tensors(table)
    loss = clf.train_step(base, idx, mean, std, torch.from_numpy(sel), y)
    jclf = table["jclf"]
    jb, jidx, jy, jm, js = jax_arrays(table)
    params, _, jloss = jclf._step(jclf.params, jclf.opt_state, jb, jidx, jm,
                                  js, jnp.asarray(sel), jy)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert max_param_diff(clf, params) <= TOL
    assert int(clf.opt_state["count"]) == 1


def test_one_epoch_of_fit_matches_jax(table, capsys):
    """The same numpy batch order (default_rng(seed)) and the same
    initial weights give the same weights after one epoch."""
    clf = port_classifier(table)
    n = len(table["y"])
    base, idx, y, mean, std = tensors(table)
    clf.fit(base, idx, y, n, 1, BATCH, 1, mean, std)
    jclf = jax_proxy.ProxyClassifier(clf.params["w1"].shape[0], NUM_PHONES,
                                     HIDDEN, 3e-3, seed=0)
    jb, jidx, jy, jm, js = jax_arrays(table)
    jclf.fit(jb, jidx, jy, n, 1, BATCH, 1, jm, js)
    assert max_param_diff(clf, jclf.params) <= TOL
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split(":")[0] == lines[1].split(":")[0] == \
        "proxy classifier epoch 1/1"
    np.testing.assert_array_equal(
        clf.predict_all(base, idx, n, 100, mean, std),
        np.asarray(jclf.predict_all(jb, jidx, n, 100, jm, js)))


def test_segment_error_rate_equals_jax():
    rng = np.random.default_rng(9)
    y = np.repeat(rng.integers(0, NUM_PHONES, size=60), 4).astype(np.int32)
    preds = np.where(rng.random(len(y)) < 0.3,
                     rng.integers(0, NUM_PHONES, size=len(y)), y)
    slices = {"a": (0, 100), "b": (100, 173), "c": (173, len(y))}
    assert (proxy_asr.segment_error_rate(preds, y, slices)
            == jax_proxy.segment_error_rate(preds, y, slices))


def test_main_separates_clean_from_noisy(table, tmp_path):
    """tests/test_proxy.py's run and gates, through both tools; the JSON
    has the JAX tool's keys."""
    noisy_scp, _ = write_corpus(table["tmp"], snr=0.3)
    results = {}
    for name, main, extra in (("port", proxy_asr.main, ["--device=cpu"]),
                              ("jax", jax_proxy.main, [])):
        out = str(tmp_path / f"{name}.json")
        assert main([f"--train_scp={table['scp']}",
                     f"--ali_scp={table['ali_scp']}",
                     f"--eval=noisy={noisy_scp}",
                     f"--holdout_scp={table['scp']}", "--context=1",
                     "--hidden=32", "--epochs=20", "--batch=128",
                     "--lr=3e-3", f"--out={out}", *extra]) == 0
        with open(out) as f:
            results[name] = json.load(f)
    result = results["port"]
    clean, noisy = result["systems"]["clean"], result["systems"]["noisy"]
    assert clean["fer"] < 0.25
    assert noisy["fer"] > clean["fer"] + 0.1
    assert 0.0 <= clean["ser"] <= clean["fer"] + 0.35
    assert result["classes"] == NUM_PHONES

    def keys(tree):
        return {k: keys(v) if isinstance(v, dict) else type(v).__name__
                for k, v in tree.items()}
    assert keys(result) == keys(results["jax"])
    assert result["train_frames"] == results["jax"]["train_frames"]


def test_mismatched_alignment_fails_legibly(tmp_path):
    scp, ali_scp = write_corpus(tmp_path, snr=4.0)
    with open(ali_scp) as f:
        utt, path = f.readline().split()
    np.save(path, np.zeros(5, np.int32))
    with pytest.raises(ValueError, match="alignment frames"):
        proxy_asr.main([f"--train_scp={scp}", f"--ali_scp={ali_scp}",
                        "--context=0", "--epochs=1", "--device=cpu"])


def test_cuda_without_a_card_raises(table):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        proxy_asr.main([f"--train_scp={table['scp']}",
                        f"--ali_scp={table['ali_scp']}"])
