"""The port's data path against the JAX package, on the CPU: the affine
geometry both ways, the ground-truth heatmaps, COCO's db, PoseDataset items
(augmented and not, over two epochs), the batch loader and its device
copies, and the flow-pair datasets and metrics, on the synthetic sets of
tests/fixtures.py.
"""

import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowtrack_tpu import config as ref_config
from flowtrack_tpu.data import coco as ref_coco
from flowtrack_tpu.data import flow_dataset as ref_flow_ds
from flowtrack_tpu.data import loader as ref_loader
from flowtrack_tpu.eval import flow_eval as ref_flow_eval
from flowtrack_tpu.ops import affine as ref_affine
from flowtrack_tpu.ops import heatmap as ref_heatmap
from flowtrack_tpu_torch import config as port_config
from flowtrack_tpu_torch.data import coco, flow_dataset, loader
from flowtrack_tpu_torch.eval import flow_eval
from flowtrack_tpu_torch.ops import affine, heatmap
from tests.fixtures import make_coco_fixture, save_image


def _cfgs(**train):
    """Port and reference configs at a small crop (64x48, heatmaps 16x12)."""
    out = []
    for mod in (port_config, ref_config):
        cfg = mod.Config()
        cfg = replace(cfg, model=replace(cfg.model, image_size=(64, 48),
                                         heatmap_size=(16, 12)),
                      train=replace(cfg.train, **train))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root, ann, det = make_coco_fixture(tmp_path_factory.mktemp("coco"),
                                       n_images=3, persons=2)
    return root, ann, det


# --- affine ------------------------------------------------------------------

@pytest.mark.parametrize("rot,shift,inv", [(0.0, (0, 0), False),
                                           (27.5, (0.1, -0.05), False),
                                           (-40.0, (0, 0), True)])
def test_numpy_affine_matches_reference(rot, shift, inv):
    c, s = np.array([120.3, 80.7]), np.array([0.9, 1.2])
    want = ref_affine.get_affine_transform(c, s, rot, (48, 64), shift, inv)
    got = affine.get_affine_transform(c, s, rot, (48, 64), shift, inv)
    np.testing.assert_array_equal(got, want)
    pts = np.random.default_rng(0).uniform(0, 200, (17, 2))
    np.testing.assert_array_equal(affine.affine_transform(pts, got),
                                  ref_affine.affine_transform(pts, want))


def test_box_and_flip_helpers_match_reference():
    for box in ([10, 20, 30, 90], [5, 5, 100, 20], [0, 0, 48, 64]):
        for a, b in zip(affine.box_to_center_scale(box, 0.75),
                        ref_affine.box_to_center_scale(box, 0.75)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    joints = rng.uniform(0, 100, (17, 2))
    for vis in (rng.integers(0, 2, 17).astype(float),
                rng.integers(0, 2, (17, 3)).astype(float)):
        for a, b in zip(affine.fliplr_joints(joints, vis, 120,
                                             port_config.COCO_FLIP_PAIRS),
                        ref_affine.fliplr_joints(joints, vis, 120,
                                                 ref_config.COCO_FLIP_PAIRS)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("inv", [False, True])
def test_tensor_affine_matches_reference(inv):
    """get_affine_transform_tensor with rotation against the reference's
    get_affine_transform_jax (float32, within 2 ulp of the largest entry),
    and against the numpy three-point construction."""
    rng = np.random.default_rng(2)
    c = rng.uniform(50, 300, (6, 2)).astype(np.float32)
    s = rng.uniform(0.3, 2.0, (6, 2)).astype(np.float32)
    s[:, 1] = s[:, 0] * 64 / 48
    r = rng.uniform(-60, 60, 6).astype(np.float32)
    want = np.asarray(ref_affine.get_affine_transform_jax(
        jnp.asarray(c), jnp.asarray(s), jnp.asarray(r), (48, 64), inv=inv))
    got = affine.get_affine_transform_tensor(torch.from_numpy(c),
                                             torch.from_numpy(s),
                                             torch.from_numpy(r), (48, 64),
                                             inv=inv).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * np.finfo(np.float32).eps
                               * np.abs(want).max())
    three = affine.get_affine_transform(c[0], s[0], float(r[0]), (48, 64),
                                        inv=inv)
    np.testing.assert_allclose(got[0], three, rtol=1e-4, atol=1e-3)
    pts = rng.uniform(0, 300, (6, 17, 2)).astype(np.float32)
    np.testing.assert_allclose(
        affine.affine_transform_tensor(torch.from_numpy(pts),
                                       torch.from_numpy(got)).numpy(),
        np.asarray(ref_affine.affine_transform_jax(jnp.asarray(pts),
                                                   jnp.asarray(want))),
        rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_warp_affine_and_crop_persons_match_reference(dtype):
    """The cv2.warpAffine twin and the batched crop, float32 and uint8
    images (uint8 blends in float32 and rounds back), rotated crops partly
    off the frame."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (40, 56, 3)).astype(dtype)
    trans = ref_affine.get_affine_transform(np.array([30.0, 18.0]),
                                            np.array([0.2, 0.27]), 25.0,
                                            (24, 32))
    want = np.asarray(ref_affine.warp_affine(jnp.asarray(img), trans, (32, 24)))
    got = affine.warp_affine(torch.from_numpy(img), trans, (32, 24)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               atol=1e-3 if dtype == np.float32 else 1.0)
    inv = np.stack([ref_affine.get_affine_transform(
        np.array([cx, 20.0]), np.array([0.2, 0.27]), rot, (24, 32), inv=True)
        for cx, rot in ((10.0, 0.0), (40.0, -30.0), (55.0, 80.0))])
    want = np.asarray(ref_affine.crop_persons(jnp.asarray(img), inv, (32, 24)))
    got = affine.crop_persons(torch.from_numpy(img), inv, (32, 24)).numpy()
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               atol=1e-3 if dtype == np.float32 else 1.0)
    x = rng.uniform(0, 255, (2, 4, 4, 3)).astype(np.float32)
    mean, std = port_config.IMAGENET_MEAN, port_config.IMAGENET_STD
    np.testing.assert_array_equal(
        affine.normalize_image(torch.from_numpy(x), mean, std).numpy(),
        np.asarray(ref_affine.normalize_image(jnp.asarray(x), mean, std)))


# --- ground-truth heatmaps ------------------------------------------------------

def _joints(rng, k=17):
    """Joints inside the crop, off it, on the 3-sigma edge, invisible."""
    joints = rng.uniform(-10, 60, (k, 2)).astype(np.float32)
    joints[0] = (-28.0, 10.0)      # box abuts the left edge (br == 0)
    joints[1] = (200.0, 10.0)      # wholly off
    vis = (rng.uniform(0, 1, k) > 0.2).astype(np.float32)
    return joints, vis


def test_generate_target_matches_reference():
    rng = np.random.default_rng(4)
    for sigma in (2.0, 3.0):
        joints, vis = _joints(rng)
        args = ((16, 12), (64, 48), sigma)
        want = ref_heatmap.generate_target_np(joints, vis, *args)
        got = heatmap.generate_target_np(joints, vis, *args)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        wj = ref_heatmap.generate_target_jax(jnp.asarray(joints),
                                             jnp.asarray(vis), *args)
        gj = heatmap.generate_target(torch.from_numpy(joints),
                                     torch.from_numpy(vis), *args)
        for a, b in zip(gj, wj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    batch = np.stack([_joints(rng)[0] for _ in range(3)])
    bvis = np.ones(batch.shape[:2], np.float32)
    wb = ref_heatmap.generate_target_batch(jnp.asarray(batch),
                                           jnp.asarray(bvis), (16, 12),
                                           (64, 48), 2.0)
    gb = heatmap.generate_target(torch.from_numpy(batch),
                                 torch.from_numpy(bvis), (16, 12), (64, 48),
                                 2.0)
    for a, b in zip(gb, wb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


# --- COCO ----------------------------------------------------------------------

def test_coco_db_matches_reference(coco_root):
    """The train db from the annotations, and the eval db from the
    detections with box NMS at 0.3, record for record; evaluate's stats
    and results."""
    root, ann, det = coco_root
    port_cfg, ref_cfg = _cfgs()
    pairs = [(coco.COCODataset(port_cfg, root, "val2017", True, ann),
              ref_coco.COCODataset(ref_cfg, root, "val2017", True, ann))]
    nms = [replace(c, test=replace(c.test, nms_thre=0.3, image_thre=0.85))
           for c in (port_cfg, ref_cfg)]
    pairs.append((coco.COCODataset(nms[0], root, "val2017", False, ann, det),
                  ref_coco.COCODataset(nms[1], root, "val2017", False, ann,
                                       det)))
    for ours, theirs in pairs:
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours.db, theirs.db):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert ours.index.person_gts_for_eval() == \
        theirs.index.person_gts_for_eval()
    # evaluate on the ground-truth joints of the train db, as the reference
    db = pairs[0][0].db
    args = (np.stack([r["joints"] for r in db]),
            np.ones((len(db), 17), np.float32),
            np.asarray([r["score"] for r in db], np.float32),
            np.asarray([r["image_id"] for r in db]))
    got, want = ours.evaluate(*args), theirs.evaluate(*args)
    assert got == want and got[0]["AP"] == 1.0


@pytest.mark.parametrize("train", [False, True])
def test_pose_dataset_items_match_reference_bitwise(coco_root, train):
    """Every item, augmented (scale, rotation, flip from each item's own
    generator) or not, over two epochs: bit for bit when both warp with
    cv2."""
    pytest.importorskip("cv2")
    root, ann, _ = coco_root
    # eval items on the ground-truth boxes
    port_cfg, ref_cfg = (replace(c, test=replace(c.test, use_gt_bbox=True))
                         for c in _cfgs(flip_prob=0.5))
    ours = coco.COCODataset(port_cfg, root, "val2017", train, ann, seed=3)
    theirs = ref_coco.COCODataset(ref_cfg, root, "val2017", train, ann, seed=3)
    flipped = 0
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{epoch} {i} {key}")
            flipped += bool(a["center"][0]
                            != np.float32(ours.db[i]["center"][0]))
    assert (flipped > 0) == train


def test_pose_dataset_without_cv2_matches_reference(coco_root, monkeypatch):
    """Where cv2 is missing both read with PIL and warp with their
    warp_affine: augmented items within 1e-5."""
    root, ann, _ = coco_root
    monkeypatch.setitem(sys.modules, "cv2", None)
    port_cfg, ref_cfg = _cfgs()
    ours = coco.COCODataset(port_cfg, root, "val2017", True, ann, seed=5)
    theirs = ref_coco.COCODataset(ref_cfg, root, "val2017", True, ann, seed=5)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            for key in a:
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5,
                                           err_msg=f"{epoch} {i} {key}")


# --- the loader -----------------------------------------------------------------

class _Items:
    """A dataset of numbered items that records set_epoch."""

    def __init__(self, n):
        self.n, self.epochs = n, []

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32), "i": np.int64(i)}


@pytest.mark.parametrize("shuffle,drop_last,pad", [(True, False, True),
                                                   (True, True, False),
                                                   (False, False, False)])
def test_batch_loader_order_and_padding_match_reference(shuffle, drop_last,
                                                        pad):
    """Two epochs of 11 items in batches of 4: the same shuffled order, the
    same short or dropped last batch, padding and n_valid, and set_epoch
    called with 0 then 1."""
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
              pad_to_batch=pad, seed=7, num_workers=3)
    ours, theirs = _Items(11), _Items(11)
    lo, lr = loader.BatchLoader(ours, **kw), ref_loader.BatchLoader(theirs, **kw)
    assert len(lo) == len(lr)
    for _ in range(2):
        got, want = list(lo), list(lr)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    assert ours.epochs == theirs.epochs == [0, 1]


def test_batch_loader_relays_item_errors():
    class Bad(_Items):
        def __getitem__(self, i):
            if i == 5:
                raise ValueError("bad item")
            return super().__getitem__(i)

    with pytest.raises(ValueError, match="bad item"):
        list(loader.BatchLoader(Bad(8), batch_size=2, num_workers=2))


def test_device_prefetch_on_the_cpu():
    """Batches arrive as tensors on the asked device, in order, n_valid a
    Python int; 'cuda' is the default and needs a card."""
    batches = list(loader.BatchLoader(_Items(5), batch_size=2,
                                      pad_to_batch=True))
    out = list(loader.device_prefetch(iter(batches), "cpu", size=2))
    assert [b["n_valid"] for b in out] == [2, 2, 1]
    for got, want in zip(out, batches):
        assert isinstance(got["x"], torch.Tensor) and got["x"].device.type == "cpu"
        np.testing.assert_array_equal(got["x"].numpy(), want["x"])
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            next(loader.device_prefetch(iter(batches)))


# --- flow data ----------------------------------------------------------------

@pytest.fixture(scope="module")
def chairs(tmp_path_factory):
    """Five FlyingChairs-layout triplets of 40x56 frames."""
    root = tmp_path_factory.mktemp("chairs")
    rng = np.random.default_rng(8)
    for i in range(5):
        for k in (1, 2):
            save_image(os.path.join(root, f"{i:05d}_img{k}.png"),
                       rng.integers(0, 256, (40, 56, 3), np.uint8))
        ref_flow_eval.write_flo(os.path.join(root, f"{i:05d}_flow.flo"),
                                rng.normal(0, 3, (40, 56, 2)))
    return str(root)


@pytest.mark.parametrize("drop_last", [True, False])
def test_flow_batches_match_reference(chairs, drop_last):
    """Random crops and flips from flow_batches' generator, and the padded
    last batch, equal the reference's."""
    kw = dict(crop_size=(32, 48), is_train=True, vflip_prob=0.5)
    ours = flow_dataset.FlowPairDataset(chairs, **kw)
    theirs = ref_flow_ds.FlowPairDataset(chairs, **kw)
    got = list(flow_dataset.flow_batches(ours, 2, seed=4, drop_last=drop_last))
    want = list(ref_flow_ds.flow_batches(theirs, 2, seed=4,
                                         drop_last=drop_last))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for a, b in zip(got, want):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    centre = flow_dataset.FlowPairDataset(chairs, crop_size=(32, 48))[1]
    for a, b in zip(centre, ref_flow_ds.FlowPairDataset(
            chairs, crop_size=(32, 48))[1]):
        np.testing.assert_array_equal(a, b)


def test_flow_eval_matches_reference(tmp_path):
    rng = np.random.default_rng(9)
    flow = rng.normal(size=(7, 9, 2)).astype(np.float32)
    flow_eval.write_flo(str(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(ref_flow_eval.read_flo(str(tmp_path / "a.flo")),
                                  flow)
    np.testing.assert_array_equal(flow_eval.read_flo(str(tmp_path / "a.flo")),
                                  flow)
    preds = [rng.normal(0, 3, (7, 9, 2)) for _ in range(3)]
    gts = [rng.normal(0, 3, (7, 9, 2)) for _ in range(3)]
    valids = [rng.uniform(0, 1, (7, 9)) > 0.3 for _ in range(3)]
    assert flow_eval.evaluate_flow_pairs(preds, gts, valids) == \
        ref_flow_eval.evaluate_flow_pairs(preds, gts, valids)
    assert flow_eval.flow_error_stats(preds[0], gts[0]) == \
        ref_flow_eval.flow_error_stats(preds[0], gts[0])
    with pytest.raises(ValueError):
        flow_eval.evaluate_flow_pairs(preds, gts[:2])
