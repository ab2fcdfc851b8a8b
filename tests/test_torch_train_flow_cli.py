"""The port's ``tools/train_flow`` against the JAX package's on the
constant-flow corpus of tests/test_flow_dataset.py (4 pairs of 64x64, flow
(4, -2)), FlowNetS in float32, with validation and checkpoints.

The reference's ``--batch`` is per device and its mesh has 8 CPU devices
(tests/conftest.py); the port runs on one. So the reference is given
``--batch 1`` and the port ``--batch 8``: each epoch is one step on the 4
pairs and 4 repeats, shuffled and augmented alike (the epoch seeds both).
The reference starts from ``PRNGKey(0)`` inside its ``main`` and has no
argument for weights, so the test gives the port the same start by
swapping its model constructor for one that loads the reference's init tree.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowtrack_tpu import config as ref_config
from flowtrack_tpu.engine.checkpoint import load_npz_variables
from flowtrack_tpu.models.flownet import get_flow_net as ref_get_flow_net
from flowtrack_tpu_torch.data.flow_dataset import FlowPairDataset
from flowtrack_tpu_torch.models.flownet import get_flow_net, preprocess_pair
from flowtrack_tpu_torch.tools import train_flow
from flowtrack_tpu_torch.tools.common import flow_net
from flowtrack_tpu_torch.utils.convert import load_flownet
from tests.test_flow_dataset import _make_triplet_corpus
from tools import train_flow as ref_train_flow

EPOCHS = 2
# per-epoch EPE (px), relative: epoch 0's train EPE is the shared start's
# forward, the rest follow Adam steps from gradients that XLA and the CPU
# convs sum in other orders (read equal at the 4 decimals both CLIs log)
EPE_RTOL = 1e-4
# the saved weights through both packages' FlowNetS at inference,
# float32: max |port - reference| over max |reference| (read 9.1e-7)
FLOW_RTOL = 1e-5


def ref_flownet_s():
    return ref_get_flow_net(ref_config.FlowConfig(variant="flownet_s",
                                                  dtype="float32"))


def metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The corpus, the reference's init tree and the reference CLI's run
    (its metrics.jsonl lines)."""
    tmp = tmp_path_factory.mktemp("train_flow")
    corpus = tmp / "chairs"
    corpus.mkdir()
    _make_triplet_corpus(corpus, n=4, hw=(64, 64), flow_val=(4.0, -2.0))
    argv = ["--cfg", "flownet_s", "--triplets", str(corpus),
            "--val-triplets", str(corpus), "--crop", "64", "64",
            "--epochs", str(EPOCHS), "flow.dtype=float32", "train.lr=1e-4"]
    mp = pytest.MonkeyPatch()
    try:
        # no --ckpt-dir: its metrics.jsonl lands beside --out, and no
        # orbax checkpoint of 0.5 GB is written an epoch
        (tmp / "ref").mkdir()
        mp.setattr(sys, "argv", [
            "train_flow.py", "--compile-cache=", "--batch", "1", "--out",
            str(tmp / "ref" / "ref.npz"), *argv])
        ref_train_flow.main()
    finally:
        mp.undo()
    init = jax.jit(ref_flownet_s().init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)), train=False)
    yield {"tmp": tmp, "corpus": corpus, "argv": argv,
           "init": jax.tree.map(np.asarray, init),
           "ref": metrics(tmp / "ref" / "metrics.jsonl")}
    shutil.rmtree(tmp, ignore_errors=True)  # checkpoints of 0.5 GB each


def port_main(run, monkeypatch, *extra):
    monkeypatch.setattr(
        train_flow, "get_flow_net",
        lambda cfg, generator=None: load_flownet(get_flow_net(cfg),
                                                 run["init"]))
    tmp = run["tmp"]
    return train_flow.main(["--batch", "8", "--device", "cpu",
                            "--ckpt-dir", str(tmp / "ckpt"), "--out",
                            str(tmp / "port.npz"), *run["argv"], *extra])


def test_train_flow_matches_reference(run, monkeypatch):
    """Per epoch the train and validation EPE within EPE_RTOL, the
    reference's keys; then the port's .npz through the reference's FlowNetS
    gives the port's flow."""
    port_main(run, monkeypatch)
    tmp = run["tmp"]
    got, want = metrics(tmp / "ckpt" / "metrics.jsonl"), run["ref"]
    assert len(got) == len(want) == EPOCHS
    for epoch, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"step", "time", "epe", "seconds",
                                    "val_epe"}
        assert g["step"] == w["step"] == epoch
        for k in ("epe", "val_epe"):
            assert np.isfinite(g[k])
            assert g[k] == pytest.approx(w[k], rel=EPE_RTOL), (epoch, k)
    assert {"epoch_000000.pt", "epoch_000001.pt"} <= set(
        os.listdir(tmp / "ckpt"))

    im1, im2, _ = FlowPairDataset(root=str(run["corpus"]))[0]
    cfg = train_flow.apply_overrides(train_flow.get_config("flownet_s"),
                                     ["flow.dtype=float32"])
    port = flow_net(cfg, str(tmp / "port.npz"))
    x = preprocess_pair(torch.from_numpy(im1)[None],
                        torch.from_numpy(im2)[None])
    with torch.no_grad():
        got = port(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    variables = jax.tree.map(jnp.asarray,
                             load_npz_variables(str(tmp / "port.npz")))
    want = np.asarray(ref_flownet_s().apply(
        variables, jnp.asarray(x.numpy()), train=False))
    err = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
    assert err <= FLOW_RTOL, err


def test_resume_continues_at_the_next_epoch(run, monkeypatch, capsys):
    """``--resume --epochs 3`` after the two epochs above runs epoch 2
    alone, from the newest checkpoint's step."""
    if not (run["tmp"] / "ckpt" / "epoch_000001.pt").exists():
        port_main(run, monkeypatch)
    capsys.readouterr()
    argv = list(run["argv"])
    argv[argv.index("--epochs") + 1] = "3"
    monkeypatch.setitem(run, "argv", argv)
    state = port_main(run, monkeypatch, "--resume")
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out
    epochs = [line for line in out.splitlines() if '"epoch"' in line]
    assert len(epochs) == 1 and '"epoch": 2' in epochs[0]
    assert state.step == 3


def test_crop_must_divide_by_64(run, tmp_path):
    with pytest.raises(SystemExit, match="/64-divisible"):
        train_flow.main(["--triplets", str(run["corpus"]), "--crop", "48",
                         "64", "--device", "cpu", "--out",
                         str(tmp_path / "x.npz")])


def test_channelnorm_gradient_is_zero_at_a_zero_norm():
    """FlowNet2's brightness errors are channel norms of frame differences,
    and a pixel equal in both frames (common in smooth or flat images)
    makes one exactly 0. There the reference's gradient is NaN, which the
    train step spreads into every weight under it; the port's is 0 (the
    lineage's ChannelNorm backward divides by the norm plus 1e-9). Elsewhere
    the two agree within float32 rounding (the sums run in other orders)."""
    from flowtrack_tpu.ops.warp import channelnorm as ref_channelnorm
    from flowtrack_tpu_torch.ops.warp import channelnorm

    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 5, 7, 3)).astype(np.float32)
    x[0, 2, 3] = 0.0
    g = rng.normal(0, 1, (2, 5, 7, 1)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = channelnorm(xt)
    (out * torch.from_numpy(g)).sum().backward()
    want, vjp = jax.vjp(ref_channelnorm, jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)
    assert np.isnan(want_grad[0, 2, 3]).all()
    got = xt.grad.numpy()
    assert (got[0, 2, 3] == 0).all() and np.isfinite(got).all()
    keep = np.ones(x.shape[:3], bool)
    keep[0, 2, 3] = False
    np.testing.assert_allclose(got[keep], want_grad[keep], rtol=1e-6,
                               atol=1e-7)
