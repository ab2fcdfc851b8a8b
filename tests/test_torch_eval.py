"""The port's evaluation layer against the JAX package, on the CPU: the COCO
keypoint evaluator, the PoseTrack evaluator's two backends, the native NMS
(built with g++ and its numpy route), COCODataset.evaluate (OKS-NMS and
soft OKS-NMS, the results json), the PoseTrack and MPII datasets with
PCKh.

Every case of tests/test_coco_eval.py, tests/test_native_nms.py and the
PoseTrack-eval cases of tests/test_tracker.py runs here with the names it
uses pointing at stand-ins that call the reference and the port on the same
inputs, require equal results (the same numpy code on both sides: exact)
and hand the port's on to the case's own assertions. The PoseTrack and MPII
cases of tests/test_datasets.py run with the port's datasets.
"""

import copy
import json
import os
from dataclasses import asdict, fields, replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.test_coco_eval as coco_cases
import tests.test_datasets as dataset_cases
import tests.test_native_nms as nms_cases
import tests.test_tracker as tracker_cases
from flowtrack_tpu import config as ref_config
from flowtrack_tpu import native as ref_native
from flowtrack_tpu.data import coco as ref_coco
from flowtrack_tpu.data import mpii as ref_mpii
from flowtrack_tpu.data import posetrack as ref_posetrack
from flowtrack_tpu.eval import coco_eval as ref_coco_eval
from flowtrack_tpu.eval import posetrack_eval as ref_pt_eval
from flowtrack_tpu.ops import decode as ref_decode
from flowtrack_tpu_torch import config as port_config
from flowtrack_tpu_torch import native
from flowtrack_tpu_torch.data import coco, mpii, posetrack
from flowtrack_tpu_torch.eval import coco_eval, posetrack_eval
from flowtrack_tpu_torch.ops import decode
from flowtrack_tpu_torch.ops.affine import (affine_transform,
                                            get_affine_transform)
from flowtrack_tpu_torch.ops.heatmap import generate_target_np
from tests.fixtures import (draw_person, make_coco_fixture,
                            make_posetrack_fixture, save_image, synth_pose)


def assert_same(got, want, path="result"):
    """Equal structure and values; arrays and floats bit for bit (NaN equal
    to NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic, float, int)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)
    else:
        assert got == want, path


def both(ref_fn, port_fn):
    """A stand-in that runs the reference and the port on copies of the same
    arguments, requires equal results and returns the port's."""
    def run(*args, **kwargs):
        want = ref_fn(*copy.deepcopy(args), **copy.deepcopy(kwargs))
        got = port_fn(*args, **kwargs)
        assert_same(got, want)
        return got
    return run


class BothCOCOEval:
    """COCOKeypointEval of both packages on the same gts and dts."""

    def __init__(self, *args, **kwargs):
        self.ref = ref_coco_eval.COCOKeypointEval(*copy.deepcopy(args),
                                                  **copy.deepcopy(kwargs))
        self.port = coco_eval.COCOKeypointEval(*args, **kwargs)

    def evaluate(self):
        return both(self.ref.evaluate, self.port.evaluate)()


def port_cfg(cfg):
    """A reference Config as the port's, section for section (the mesh
    dropped)."""
    sections = {}
    for f in fields(port_config.Config):
        value = getattr(cfg, f.name)
        if f.name != "name":
            value = type(getattr(port_config.Config(), f.name))(
                **asdict(value))
        sections[f.name] = value
    return port_config.Config(**sections)


# --- COCO keypoint AP ------------------------------------------------------------

COCO_CASES = sorted(n for n in dir(coco_cases) if n.startswith("test_"))


@pytest.mark.parametrize("case", COCO_CASES)
def test_coco_eval_cases_through_both(case, monkeypatch, rng):
    """Each case of tests/test_coco_eval.py, with COCOKeypointEval,
    compute_oks and summarize giving the reference's results from the
    port."""
    monkeypatch.setattr(coco_cases, "COCOKeypointEval", BothCOCOEval)
    monkeypatch.setattr(coco_cases, "compute_oks",
                        both(ref_coco_eval.compute_oks, coco_eval.compute_oks))
    monkeypatch.setattr(coco_cases, "summarize",
                        both(ref_coco_eval.summarize, coco_eval.summarize))
    assert coco_cases.MAX_DETS == coco_eval.MAX_DETS
    fn = getattr(coco_cases, case)
    fn(rng) if "rng" in fn.__code__.co_varnames[:fn.__code__.co_argcount] \
        else fn()


def test_coco_eval_random_scenarios_match_reference():
    """Seeded random mixes of misses, duplicates, spurious poses, crowd and
    unlabeled ground truth: equal stats and OKS matrices."""
    rng = np.random.default_rng(11)
    for trial in range(20):
        gts, dts = coco_cases._random_scenario(rng, n_images=5)
        for i, g in enumerate(gts):
            if i % 5 == 1:
                g["iscrowd"] = 1
            if i % 7 == 2:
                g["keypoints"] = [0.0] * len(g["keypoints"])
                g["num_keypoints"] = 0
        assert_same(coco_eval.COCOKeypointEval(gts, dts).evaluate(),
                    ref_coco_eval.COCOKeypointEval(gts, dts).evaluate())
        if gts and dts:
            assert_same(coco_eval.compute_oks(gts, dts),
                        ref_coco_eval.compute_oks(gts, dts))


# --- native NMS ------------------------------------------------------------------

NMS_CASES = sorted(n for n in dir(nms_cases) if n.startswith("test_"))


@pytest.mark.parametrize("route", ["built", "numpy"])
@pytest.mark.parametrize("case", NMS_CASES)
def test_native_nms_cases_through_both(case, route, monkeypatch, rng):
    """Each case of tests/test_native_nms.py with ``native`` the port's,
    built with g++ or on its numpy route, every call equal to the
    reference's native NMS; the cases' own oracle stays the reference's
    numpy NMS."""
    assert native.available()
    if route == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
    stand_in = SimpleNamespace(
        cpu_nms=both(ref_native.cpu_nms, native.cpu_nms),
        cpu_oks_nms=both(ref_native.cpu_oks_nms, native.cpu_oks_nms),
        available=native.available)
    monkeypatch.setattr(nms_cases, "native", stand_in)
    fn = getattr(nms_cases, case)
    fn(rng) if "rng" in fn.__code__.co_varnames[:fn.__code__.co_argcount] \
        else fn()


def test_native_library_lives_in_the_build_directory():
    """The library is built under build/flowtrack_tpu_torch/ with the
    source's hash in its name, never beside the source."""
    path = native.library_path()
    assert path.parent.parts[-2:] == ("build", "flowtrack_tpu_torch")
    assert native.available() and path.exists()
    assert not list(native.SRC.parent.glob("*.so"))


def test_native_without_toolchain_warns_and_falls_back(monkeypatch, caplog,
                                                       tmp_path):
    """No g++: a logged warning, and the numpy NMS answers."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    dets = nms_cases.random_dets(np.random.default_rng(3))
    with caplog.at_level("WARNING", logger="flowtrack.native"):
        got = native.cpu_nms(dets, 0.5)
    assert "numpy fallback" in caplog.text and not native.available()
    assert list(got) == list(ref_native.cpu_nms(dets, 0.5))


# --- PoseTrack evaluation ------------------------------------------------------------

PT_CASES = [(cls, name) for cls in ("TestPoseTrackEval",
                                    "TestPoseTrackEvalEdges",
                                    "TestPoseTrackEvalBackends")
            for name in sorted(dir(getattr(tracker_cases, cls)))
            if name.startswith("test_")]


@pytest.mark.parametrize("cls,case", PT_CASES)
def test_posetrack_eval_cases_through_both(cls, case, monkeypatch):
    """The PoseTrack-eval cases of tests/test_tracker.py, each evaluator
    call made by both packages and equal."""
    originals = {name: getattr(ref_pt_eval, name) for name in
                 ("evaluate_posetrack", "evaluate_posetrack_mot",
                  "match_frame", "_average_precision")}
    for name, ref_fn in originals.items():
        stand_in = both(ref_fn, getattr(posetrack_eval, name))
        # the cases import some of these from the module when they run
        monkeypatch.setattr(ref_pt_eval, name, stand_in)
        if hasattr(tracker_cases, name):
            monkeypatch.setattr(tracker_cases, name, stand_in)
    getattr(getattr(tracker_cases, cls)(), case)()


@pytest.mark.parametrize("fully_labeled", [True, False])
def test_posetrack_backends_match_reference_on_200_scenarios(fully_labeled):
    """Both MOTA formulations on seeded random scenarios (misses, switches,
    spurious poses, unlabeled joints), several sequences at once: every
    count, every per-joint array equal."""
    rng = np.random.default_rng(5 if fully_labeled else 6)
    scenario = tracker_cases.TestPoseTrackEvalBackends._random_scenario
    for _ in range(100):
        seqs = [scenario(rng, fully_labeled) for _ in range(2)]
        gts, preds = [s[0] for s in seqs], [s[1] for s in seqs]
        for port_fn, ref_fn in ((posetrack_eval.evaluate_posetrack,
                                 ref_pt_eval.evaluate_posetrack),
                                (posetrack_eval.evaluate_posetrack_mot,
                                 ref_pt_eval.evaluate_posetrack_mot)):
            assert_same(port_fn(gts, preds), ref_fn(gts, preds))


def test_posetrack_eval_length_checks():
    with pytest.raises(ValueError, match="sequences"):
        posetrack_eval.evaluate_posetrack([[]], [])
    with pytest.raises(ValueError, match="frames"):
        posetrack_eval.evaluate_posetrack_mot([[[]]], [[[], []]])


# --- datasets ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def posetrack_root(tmp_path_factory):
    return make_posetrack_fixture(tmp_path_factory.mktemp("pt"))


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return make_coco_fixture(tmp_path_factory.mktemp("coco"))


def test_posetrack_dataset_case_on_the_port(posetrack_root, monkeypatch):
    """tests/test_datasets.py's PoseTrack case with the port's dataset."""
    monkeypatch.setattr(
        dataset_cases, "PoseTrackDataset",
        lambda cfg, *a, **k: posetrack.PoseTrackDataset(port_cfg(cfg), *a,
                                                        **k))
    dataset_cases.TestPoseTrack().test_sequences_and_annotations(
        posetrack_root)


def test_posetrack_dataset_matches_reference(posetrack_root):
    """Sequences, per-frame annotations with head sizes, frame paths, the
    db and an item, against the reference's dataset."""
    root, _ = posetrack_root
    cfg = replace(dataset_cases.CFG, test=replace(dataset_cases.CFG.test,
                                                  use_gt_bbox=True))
    ours = posetrack.PoseTrackDataset(port_cfg(cfg), root, "val", False)
    theirs = ref_posetrack.PoseTrackDataset(cfg, root, "val", False)
    assert_same(ours.sequences(), theirs.sequences())
    for frames in theirs.sequences().values():
        for image_id in frames:
            assert_same(ours.frame_annotations(image_id),
                        theirs.frame_annotations(image_id))
            assert ours.frame_path(image_id) == theirs.frame_path(image_id)
    assert_same(ours.db, theirs.db)
    a, b = ours[1], theirs[1]
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5,
                                   err_msg=key)


def _mpii_fixture(path, rng, size):
    os.makedirs(path / "annot", exist_ok=True)
    os.makedirs(path / "images", exist_ok=True)
    anns = []
    for i in range(3):
        joints = synth_pose(rng, 150, 120, size=size)[:16]
        img = np.zeros((240, 320, 3), np.uint8)
        draw_person(img, joints)
        save_image(str(path / "images" / f"{i}.png"), img)
        ann = {"image": f"{i}.png", "center": [150.0, 120.0], "scale": 0.8,
               "joints": joints.tolist(), "joints_vis": [1] * 16}
        if i == 2:   # one record with a head box, as MPII's own
            ann["headbox"] = [130.0, 60.0, 170.0, 105.0]
        anns.append(ann)
    with open(path / "annot" / "valid.json", "w") as f:
        json.dump(anns, f)


def test_mpii_dataset_case_on_the_port(tmp_path, monkeypatch):
    """tests/test_datasets.py's MPII db-and-PCKh case with the port's
    dataset."""
    monkeypatch.setattr(
        dataset_cases, "MPIIDataset",
        lambda cfg, *a, **k: mpii.MPIIDataset(port_cfg(cfg), *a, **k))
    dataset_cases.TestMPII().test_mpii_db_and_pckh(tmp_path)


def test_mpii_db_and_pckh_match_reference(tmp_path):
    """The MPII db (the lineage's center and scale adjustment, head sizes
    from the head box or the scale) and PCKh on perfect, noisy and shifted
    predictions: equal records and stats."""
    _mpii_fixture(tmp_path, np.random.default_rng(0), 80)
    cfg = ref_config.Config(model=ref_config.ModelConfig(num_joints=16))
    ours = mpii.MPIIDataset(port_cfg(cfg), str(tmp_path), "valid", False)
    theirs = ref_mpii.MPIIDataset(cfg, str(tmp_path), "valid", False)
    assert_same(ours.db, theirs.db)
    rng = np.random.default_rng(1)
    preds = np.stack([r["joints"] for r in theirs.db])
    for p in (preds, preds + rng.normal(0, 6, preds.shape), preds + 300):
        assert_same(ours.evaluate(p), theirs.evaluate(p))
    assert ours.evaluate(preds)["Mean"] == 1.0


def test_mpii_decode_round_trip_pckh_matches_reference(tmp_path):
    """tests/test_datasets.py's MPII eval slice through the port: planted
    heatmaps on each record's crop, the port's decode on the CPU, PCKh 1.0,
    the decoded joints within 1e-4 px of the reference's decode."""
    _mpii_fixture(tmp_path, np.random.default_rng(0), 70)
    cfg = ref_config.Config(model=ref_config.ModelConfig(
        image_size=(256, 256), heatmap_size=(64, 64), num_joints=16,
        sigma=2.0))
    ours = mpii.MPIIDataset(port_cfg(cfg), str(tmp_path), "valid", False)
    hms, centers, scales = [], [], []
    for rec in ours.db:
        trans = get_affine_transform(rec["center"], rec["scale"], 0.0,
                                     (256, 256))
        jc = affine_transform(np.asarray(rec["joints"]), trans)
        hm, _ = generate_target_np(jc, rec["joints_vis"], (64, 64),
                                   (256, 256), 2.0)
        hms.append(hm)
        centers.append(rec["center"])
        scales.append(rec["scale"])
    hms = np.stack(hms)
    centers = np.stack(centers).astype(np.float32)
    scales = np.stack(scales).astype(np.float32)
    got, _ = decode.get_final_preds(torch.from_numpy(hms),
                                    torch.from_numpy(centers),
                                    torch.from_numpy(scales))
    want, _ = ref_decode.get_final_preds(jnp.asarray(hms),
                                         jnp.asarray(centers),
                                         jnp.asarray(scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert ours.evaluate(got.numpy())["Mean"] == 1.0


@pytest.mark.parametrize("soft", [False, True])
def test_coco_evaluate_matches_reference(coco_root, tmp_path, soft):
    """COCODataset.evaluate with OKS-NMS (native) or soft OKS-NMS on noisy
    duplicated poses: the same stats, the same results, the same results
    json."""
    root, _, _ = coco_root
    cfg = replace(dataset_cases.CFG, test=replace(
        dataset_cases.CFG.test, use_gt_bbox=True, soft_nms=soft))
    ours = coco.COCODataset(port_cfg(cfg), root, "val2017", False)
    theirs = ref_coco.COCODataset(cfg, root, "val2017", False)
    gt = ref_coco.COCODataset(cfg, root, "val2017", True)
    rng = np.random.default_rng(2)
    joints = np.stack([g["joints"] for g in gt.db])
    # every person twice: once close, once off by a few pixels
    preds = np.concatenate([joints + rng.normal(0, 1, joints.shape),
                            joints + rng.normal(0, 6, joints.shape)])
    n = len(preds)
    maxvals = rng.uniform(0.1, 1, (n, 17)).astype(np.float32)
    scores = rng.uniform(0.5, 1, n).astype(np.float32)
    ids = np.tile([r["image_id"] for r in ours.db], 2)
    got = ours.evaluate(preds, maxvals, scores, ids,
                        output_dir=str(tmp_path / "port"))
    want = theirs.evaluate(preds, maxvals, scores, ids,
                           output_dir=str(tmp_path / "ref"))
    assert_same(got, want)
    assert 0.3 < got[0]["AP"] <= 1.0
    name = "keypoints_val2017_results.json"
    assert (tmp_path / "port" / name).read_text() == \
        (tmp_path / "ref" / name).read_text()


def test_soft_nms_eval_case_on_the_port(coco_root, monkeypatch):
    """tests/test_datasets.py's soft-NMS eval case with the port's
    dataset."""
    monkeypatch.setattr(
        dataset_cases, "COCODataset",
        lambda cfg, *a, **k: coco.COCODataset(port_cfg(cfg), *a, **k))
    dataset_cases.test_soft_nms_eval_path(coco_root)


def test_print_eval_prints_the_summary(coco_root, capsys):
    root, _, det = coco_root
    ds = coco.COCODataset(port_cfg(dataset_cases.CFG), root, "val2017",
                          False, bbox_file=det)
    stats = {k: 0.5 for k in ("AP", "AP50", "AP75", "APm", "APl", "AR",
                              "AR50", "AR75", "ARm", "ARl")}
    ds.print_eval(stats)
    assert capsys.readouterr().out == ref_coco_eval.summarize(stats) + "\n"
