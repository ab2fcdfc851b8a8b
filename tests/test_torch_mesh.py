"""The port's multi-device inference against the JAX package, on the CPU.

The port's meshes here repeat the CPU device (``make_mesh(devices=[cpu] *
n)``): each slot's work is dispatched, run and gathered as on distinct
cards, one slot after another. The reference runs on its 8-device virtual
CPU mesh (tests/conftest.py). Held: ``pad_to_multiple`` bit for bit, the
sharding helpers; sharded ``track_clips`` on a (clip, frame) mesh in the
keyframe mode against the reference's run on its own (2, 2) mesh with the
same weights (one compile of the reference's program covers the clip
split, the frame split and the keyframe rule); the 1-D ``track_clips`` and
the frame-sharded ``track_clip`` against the port unsharded, which
tests/test_torch_clip_pipeline.py holds to the reference; the sharded
``MultiStreamTracker`` against unsharded and the reference's sharded ids
(a forced partial step on a mesh it does not divide included);
``device_prefetch(sharding=)``; ``run_validation(mesh=)``'s gathered
arrays bit for bit against unsharded, and against the reference's
sharded validation on the same .npz weights.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from flowtrack_tpu import parallel as ref_parallel
from flowtrack_tpu.serving import MultiStreamTracker as JMultiStreamTracker
from flowtrack_tpu_torch.parallel import (Mesh, NamedSharding, batch_sharding,
                                          device_put, make_mesh, mesh_for,
                                          pad_to_multiple, replicas,
                                          replicated, shard_batch)
from flowtrack_tpu_torch.serving import MultiStreamTracker
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker
from tests.test_serving import CLIP, scenario_a, scenario_b
from tests.test_torch_clip_pipeline import (P, _assert_outputs_match, _clip,
                                            trackers)  # noqa: F401
from tests.test_torch_clip_scenarios import StubFlowTorch, StubPoseTorch
from tests.test_clip_pipeline import make_cfg

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module (and the ranks it spawns): the
    whole suite runs in six workers on the host's cores at once, and
    torch's pool of spinning threads slowed these tests a hundredfold
    there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(n, axis="data"):
    return make_mesh(0, axis, [CPU] * n)


# --- the mesh and its helpers -------------------------------------------------

@pytest.mark.parametrize("shape,multiple,axis", [
    ((13, 4), 8, 0), ((16, 4), 8, 0), ((3, 5), 4, 1), ((6, 2, 3), 4, 0),
    ((5,), 1, 0)])
def test_pad_to_multiple_matches_reference(shape, multiple, axis):
    """Bit for bit the reference's: real rows first, zeros appended, the
    array itself when it already divides."""
    x = np.random.default_rng(0).normal(size=shape)
    got, n = pad_to_multiple(x, multiple, axis)
    want, n_ref = ref_parallel.pad_to_multiple(x, multiple, axis)
    assert n == n_ref and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if shape[axis] % multiple == 0:
        assert got is x


def test_batch_sharding_uses_mesh_axis_name():
    """A mesh with another axis name shards on it without the name being
    repeated (the reference's tests/test_review_fixes.py:276)."""
    import jax

    mesh = cpu_mesh(2, "batch")
    assert batch_sharding(mesh).spec == ("batch",)
    ref = ref_parallel.batch_sharding(ref_parallel.make_mesh(2, "batch"))
    assert tuple(ref.spec) == batch_sharding(mesh).spec
    assert mesh.size == 2 and mesh.shape == {"batch": 2}
    assert mesh.axis_names == tuple(ref_parallel.make_mesh(
        2, "batch").axis_names)
    assert len(jax.devices()) == 8


def test_make_mesh_needs_cuda_or_explicit_devices():
    """No silent CPU fallback: without CUDA and without devices make_mesh
    raises; more devices than given raise; ``mesh_for`` repeats an
    explicit device."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_for("cuda")
    with pytest.raises(ValueError, match="3 devices"):
        make_mesh(3, devices=[CPU, CPU])
    assert make_mesh(1, devices=[CPU, CPU]).size == 1
    assert mesh_for("cpu").flat() == [CPU]
    assert mesh_for("cpu", 3).flat() == [CPU] * 3
    with pytest.raises(ValueError):
        Mesh(np.asarray([CPU, CPU], dtype=object), ("a", "b"))


def test_device_put_shards_and_replicates():
    """A batch axis cut into equal slot parts in slot order (refusing one
    that does not divide); a 2-D spec cuts two axes; replication shares one
    copy per distinct device; a module replica on its own device is the
    module itself."""
    mesh = cpu_mesh(4)
    x = torch.arange(24.0).reshape(8, 3)
    parts = device_put(x, batch_sharding(mesh))
    assert parts.shape == (4,)
    torch.testing.assert_close(torch.cat(list(parts)), x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not divide"):
        device_put(torch.zeros(6, 2), batch_sharding(mesh))
    same = device_put(x, replicated(mesh))
    assert all(p is x for p in same)
    net = torch.nn.Linear(2, 2)
    assert all(r is net for r in replicas(mesh, net))
    grid = Mesh(np.asarray([CPU] * 4, dtype=object).reshape(2, 2),
                ("clip", "frame"))
    y = torch.arange(16).reshape(2, 8)
    cells = device_put(y, NamedSharding(grid, ("clip", "frame")))
    assert cells.shape == (2, 2)
    assert cells[1, 0].tolist() == [[8, 9, 10, 11]]
    assert cells[0, 1].tolist() == [[4, 5, 6, 7]]
    with pytest.raises(ValueError, match="not an axis"):
        NamedSharding(grid, ("data",))


def test_part_cuts_equal_shares_in_order():
    """``part`` (every split of a batch over slots or ranks): the i-th of n
    equal parts of a list, an array or a tensor, on the leading or a later
    axis, refusing a length that does not divide."""
    from flowtrack_tpu_torch.parallel import part

    assert part(list(range(6)), 1, 3) == [2, 3]
    x = np.arange(24).reshape(4, 6)
    np.testing.assert_array_equal(part(x, 1, 2), x[2:])
    np.testing.assert_array_equal(part(x, 2, 3, axis=1), x[:, 4:])
    t = torch.from_numpy(x)
    assert torch.equal(part(t, 3, 4), t[3:])
    with pytest.raises(ValueError, match="does not divide"):
        part(x, 0, 3)


def test_shard_batch_keeps_structure_and_ints():
    """shard_batch splits every array leaf of a dict on its leading axis,
    one batch per slot, and hands ints (``n_valid``) to every slot."""
    mesh = cpu_mesh(2)
    batch = {"input": np.arange(12.0).reshape(4, 3), "n_valid": 3,
             "pair": (np.arange(4), torch.ones(4, 1))}
    slots = shard_batch(mesh, batch)
    assert len(slots) == 2 and all(s["n_valid"] == 3 for s in slots)
    np.testing.assert_array_equal(slots[1]["input"].numpy(),
                                  batch["input"][2:])
    assert slots[0]["pair"][0].tolist() == [0, 1]
    assert isinstance(slots[0]["pair"], tuple)


# --- sharded clips ------------------------------------------------------------

def _clips(c, f, seed=0):
    per = [_clip(i, f, drop_at=i + 2, seed=seed + i) for i in range(c)]
    return tuple(np.stack(x) for x in zip(*per))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_track_clips_match_unsharded(trackers, n):
    """4 clips split over an n-slot mesh: every lane equal to the port's
    unsharded batch (each slot's lanes run the same program on the same
    weights; the reference's sharded run is held in the 2-D test)."""
    _, port = trackers
    c = 4
    clips = _clips(c, 4)
    got = port.track_clips(*clips, sharding=batch_sharding(cpu_mesh(n)))
    want = port.track_clips(*clips)
    for i in range(c):
        _assert_outputs_match({k: v[i] for k, v in got.items()},
                              {k: v[i] for k, v in want.items()})
    assert got["ids"].shape == (c, 4, P + 2)


def test_sharded_track_clips_match_each_slot_alone(trackers):
    """Bit for bit: the sharded run's lanes equal run_prepared_lanes on
    each slot's group of lanes alone."""
    _, port = trackers
    clips = _clips(4, 3, seed=5)
    got = port.track_clips(*clips, sharding=batch_sharding(cpu_mesh(2)))
    for g in range(2):
        alone = port.to_host(port.run_prepared_lanes(port.prepare_lanes(
            *(x[2 * g:2 * g + 2] for x in clips))))
        for k, v in alone.items():
            np.testing.assert_array_equal(got[k][2 * g:2 * g + 2], v, k)


def test_sharded_track_clips_refuse_a_clip_count_that_does_not_divide(
        trackers):
    _, port = trackers
    with pytest.raises(ValueError, match="do not divide"):
        port.track_clips(*_clips(3, 2), sharding=batch_sharding(cpu_mesh(2)))


def _keyframe(trackers):
    """The trackers in keyframe mode (detections every second frame,
    persons carried by recovery): (reference, port) on the same nets."""
    from flowtrack_tpu.tracking.clip_pipeline import ClipTracker as JClip

    ref, port = trackers
    cfg = replace(port.cfg, track=replace(port.cfg.track, keyframe_interval=2,
                                          max_miss_age=2))
    return (JClip(cfg, ref.pose_model, ref.pose_vars, ref.flow_model,
                  ref.flow_vars),
            ClipTracker(cfg, port.pose_model, port.flow_model, device="cpu"))


def test_2d_mesh_clip_by_frame_sharding(trackers):
    """Clips over one axis of a (2, 2) mesh and each clip's frames over the
    other (the reference's tests/test_clip_pipeline.py:450), in keyframe
    mode (persons carried by recovery between detections): equal to the
    reference's run on its (2, 2) mesh and to the port unsharded."""
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding as JNamedSharding
    from jax.sharding import PartitionSpec

    ref, port = _keyframe(trackers)
    clips = _clips(2, 6, seed=3)
    grid = Mesh(np.asarray([CPU] * 4, dtype=object).reshape(2, 2),
                ("clip", "frame"))
    got = port.track_clips(*clips,
                           sharding=NamedSharding(grid, ("clip", "frame")))
    jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                  ("clip", "frame"))
    want = ref.track_clips(*clips, sharding=JNamedSharding(
        jmesh, PartitionSpec("clip", "frame")))
    plain = port.track_clips(*clips)
    assert (got["ids"] >= 0).any() and got["valid"][:, :, P:].any()
    for i in range(2):
        lane = {k: v[i] for k, v in got.items()}
        _assert_outputs_match(lane, {k: v[i] for k, v in want.items()})
        _assert_outputs_match(lane, {k: v[i] for k, v in plain.items()})


@pytest.mark.parametrize("f", [8, 6, 5])
def test_frame_sharded_clip_matches_unsharded(trackers, f):
    """One clip's frames over a 4-slot mesh, divisible and ragged (padded
    with invalid frames, the recovery budget at the real count), a drop at
    frame 3 for the recovery slots: equal to the port unsharded; the seed
    from the last real frame."""
    _, port = trackers
    clip = _clip(0, f, drop_at=3, seed=f)
    got, gseed = port.track_clip(*clip, return_seed=True,
                                 frame_sharding=batch_sharding(cpu_mesh(4)))
    plain, pseed = port.track_clip(*clip, return_seed=True)
    assert got["ids"].shape == (f, P + 2)
    _assert_outputs_match(got, plain)
    assert got["valid"][:, P:].any()
    for a, b in zip(gseed, pseed):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)


def test_frame_sharded_keyframe_and_seeded_clip(trackers):
    """Keyframe mode on a ragged clip offset into the video: frame-sharded
    equals unsharded; seeded by an earlier clip, it equals the port's
    unsharded seeded run."""
    _, kport = _keyframe(trackers)
    c1, c2 = _clip(0, 4), _clip(3, 6, seed=2)
    sharding = batch_sharding(cpu_mesh(4))
    got = kport.track_clip(*c2, frame_offset=3, frame_sharding=sharding)
    _assert_outputs_match(got, kport.track_clip(*c2, frame_offset=3))
    assert (got["ids"] >= 0).any()
    _, seed = kport.track_clip(*c1, return_seed=True)
    _assert_outputs_match(
        kport.track_clip(*c2, seed=seed, frame_offset=3,
                         frame_sharding=sharding),
        kport.track_clip(*c2, seed=seed, frame_offset=3))


def test_replica_is_built_once_and_again_after_a_load(trackers):
    """One replica per other device, reused; a net whose tensors change
    builds it anew (its graphs read the former tensors)."""
    _, port = trackers
    assert port.replica(CPU) is port
    other = ClipTracker(port.cfg, port.pose_model, port.flow_model,
                        device="cpu")
    other.device = torch.device("meta")   # stands for another card
    rep = other.replica(CPU)
    assert rep is not other and rep is other.replica(CPU)
    assert rep.pose_model is not other.pose_model
    with torch.no_grad():
        p = next(other.pose_model.parameters())
        p.data = p.data.clone()
    assert other.replica(CPU) is not rep


# --- sharded serving ----------------------------------------------------------

def _stub_tracker():
    return ClipTracker(make_cfg(), StubPoseTorch(), StubFlowTorch(),
                       device="cpu")


def _serve(tracker, streams, n, batch_streams, sharding, force=False):
    mst = MultiStreamTracker(tracker, clip_len=CLIP,
                             batch_streams=batch_streams, sharding=sharding)
    got = {sid: [None] * n for sid in streams}
    emitted = []
    for t in range(n):
        for sid, (f, b, s) in streams.items():
            mst.submit(sid, f[t], b[t], s[t])
        emitted += mst.step(force=force)
    emitted += mst.flush()
    for sid, first, tracks in emitted:
        for i, fr in enumerate(tracks):
            assert got[sid][first + i] is None
            got[sid][first + i] = fr
    return got


def _same_frames(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [x["track_id"] for x in g] == [x["track_id"] for x in w]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a["joints"], b["joints"])
            assert a["score"] == b["score"]


@pytest.mark.parametrize("mesh_size", [2, 4])
def test_multistream_sharded_matches_unsharded(mesh_size):
    """Four streams of 7 frames, clips of 4, the clip axis over the mesh
    (the reference's tests/test_serving.py:231): every stream's emissions
    equal the unsharded batched run's, and, on 2 slots, the reference's
    sharded MultiStreamTracker gives the same ids."""
    from tests.test_torch_serving import ref_tracker

    n = 7
    streams = {"A": scenario_a(n), "B": scenario_b(n),
               "C": scenario_b(n), "D": scenario_a(n)}
    tracker = _stub_tracker()
    want = _serve(tracker, streams, n, 4, None)
    got = _serve(tracker, streams, n, 4, batch_sharding(cpu_mesh(mesh_size)))
    for sid in streams:
        _same_frames(got[sid], want[sid])
    if mesh_size != 2:
        return
    jm = JMultiStreamTracker(ref_tracker(), clip_len=CLIP, batch_streams=4,
                             sharding=ref_parallel.batch_sharding(
                                 ref_parallel.make_mesh(mesh_size)))
    ref_ids = {sid: [None] * n for sid in streams}
    em = []
    for t in range(n):
        for sid, (f, b, s) in streams.items():
            jm.submit(sid, f[t], b[t], s[t])
        em += jm.step()
    em += jm.flush()
    for sid, first, tracks in em:
        for i, fr in enumerate(tracks):
            ref_ids[sid][first + i] = [x["track_id"] for x in fr]
    for sid in streams:
        assert [[x["track_id"] for x in fr] for fr in got[sid]] == \
            ref_ids[sid]


def test_sharded_forced_partial_step_runs_on_the_first_device():
    """A forced step of 3 ready lanes on a 2-slot mesh (the reference's
    tests/test_serving.py:390) runs unsharded on the mesh's first device,
    and a stream whose seed lives there moves with it: the same emissions
    as the unsharded tracker."""
    n = CLIP + 3
    streams = {sid: scenario_b(n) for sid in ("p", "q", "r")}
    tracker = _stub_tracker()
    want = _serve(tracker, streams, n, 4, None, force=True)
    got = _serve(tracker, streams, n, 4, batch_sharding(cpu_mesh(2)),
                 force=True)
    for sid in streams:
        _same_frames(got[sid], want[sid])


# --- data and validation -------------------------------------------------------

def test_device_prefetch_shards_each_batch():
    """With ``sharding`` each batch comes as its slots' parts on their
    devices, in order, ``n_valid`` a Python int on every slot: slot i's
    part is the reference's shard on its mesh's i-th device."""
    from flowtrack_tpu.data.loader import device_prefetch as ref_prefetch
    from flowtrack_tpu_torch.data.loader import device_prefetch

    batches = [{"input": np.arange(8, dtype=np.float32).reshape(4, 2) + i,
                "n_valid": np.asarray(3)} for i in range(3)]
    out = list(device_prefetch(batches, "cpu",
                               sharding=batch_sharding(cpu_mesh(2))))
    ref = list(ref_prefetch([dict(b) for b in batches],
                            ref_parallel.batch_sharding(
                                ref_parallel.make_mesh(2))))
    assert len(out) == len(ref) == 3 and all(len(b) == 2 for b in out)
    for i, (slots, want) in enumerate(zip(out, ref)):
        assert [s["n_valid"] for s in slots] == [want["n_valid"]] * 2 == [3, 3]
        assert all(type(s["n_valid"]) is int for s in slots)
        torch.testing.assert_close(
            torch.cat([s["input"] for s in slots]),
            torch.from_numpy(batches[i]["input"]), rtol=0, atol=0)
        shards = sorted(want["input"].addressable_shards,
                        key=lambda sh: sh.index[0].start)
        for slot, shard in zip(slots, shards):
            np.testing.assert_array_equal(slot["input"].numpy(),
                                          np.asarray(shard.data))


@pytest.fixture(scope="module")
def validation(tmp_path_factory):
    """A synthetic COCO set of 5 images, R18 at 64x48 crops as an .npz of
    the reference's variables, and both packages' configs for them (gt
    boxes, test.batch_size 2): (npz path, reference config, port config)."""
    from flowtrack_tpu import config as ref_config
    from flowtrack_tpu.engine.checkpoint import save_npz_variables
    from flowtrack_tpu.models.pose_resnet import get_pose_net as ref_pose_net
    from flowtrack_tpu_torch.config import apply_overrides, get_config
    from tests.fixtures import make_coco_fixture
    from tests.test_torch_clip_pipeline import _random_variables

    tmp = tmp_path_factory.mktemp("validation")
    root, _, _ = make_coco_fixture(tmp / "coco", n_images=5)
    opts = ["model.num_layers=18", "model.image_size=64,48",
            "model.heatmap_size=16,12", "model.dtype=float32",
            "test.batch_size=2", "test.use_gt_bbox=true", f"data.root={root}"]
    ref_cfg = ref_config.apply_overrides(
        ref_config.get_config("coco_res50_256x192"), opts)
    npz = str(tmp / "pose.npz")
    save_npz_variables(npz, _random_variables(ref_pose_net(ref_cfg.model),
                                              (1, 64, 48, 3), 0))
    return npz, ref_cfg, apply_overrides(get_config("coco_res50_256x192"),
                                         opts)


def _validate(run, dataset, *args, **kwargs):
    """``run(*args, dataset=dataset, **kwargs)``: its stats and the arrays
    it evaluated, gathered in order (preds, maxvals, scores, image_id)."""
    seen = {}
    evaluate = dataset.evaluate

    def spy(preds, maxvals, scores, ids, **kw):
        seen.update(preds=preds, maxvals=maxvals, scores=scores, image_id=ids)
        return evaluate(preds, maxvals, scores, ids, **kw)

    dataset.evaluate = spy
    try:
        return run(*args, dataset=dataset, **kwargs), seen
    finally:
        del dataset.evaluate


def test_run_validation_on_a_mesh_matches_unsharded(validation):
    """run_validation over a 2-slot mesh (batch test.batch_size * 2, a
    model replica a device, results gathered in order), and over the 3-slot
    mesh the config asks for: every gathered array bit for bit the
    unsharded run's and the same AP table. Each box's joints differ from
    every other's, so a slot's results out of order, twice or missing would
    show."""
    from flowtrack_tpu_torch.data import COCODataset
    from flowtrack_tpu_torch.tools.common import pose_net
    from flowtrack_tpu_torch.tools.test import run_validation

    npz, _, cfg = validation
    model = pose_net(cfg, npz)
    ds = COCODataset(cfg, cfg.data.root, "val2017", is_train=False)
    want, plain = _validate(run_validation, ds, cfg, model, device="cpu")
    n = len(ds)
    assert len(plain["image_id"]) == n and n % 4 and n > 6
    assert len(np.unique(plain["preds"].reshape(n, -1), axis=0)) == n
    cfg3 = replace(cfg, mesh=replace(cfg.mesh, num_devices=3))
    for c, kw in ((cfg, {"mesh": cpu_mesh(2)}), (cfg3, {})):
        got, arrays = _validate(run_validation, ds, c, model, device="cpu",
                                **kw)
        assert got == want
        for k, v in plain.items():
            np.testing.assert_array_equal(arrays[k], v, k)


def test_run_validation_on_a_mesh_matches_reference(validation):
    """The port's and the reference's run_validation, each over a 2-slot
    mesh of its own, on the same .npz weights: the AP table within 1e-6,
    the gathered image ids equal, the joints within 1e-3 px and the maxvals
    and scores within 1e-5 relative, row by row."""
    import jax
    import jax.numpy as jnp

    from flowtrack_tpu.data import COCODataset as RefCOCODataset
    from flowtrack_tpu.engine.checkpoint import load_npz_variables
    from flowtrack_tpu.models.pose_resnet import get_pose_net as ref_pose_net
    from flowtrack_tpu_torch.data import COCODataset
    from flowtrack_tpu_torch.tools.common import pose_net
    from flowtrack_tpu_torch.tools.test import run_validation
    from tools import test as ref_test

    npz, ref_cfg, cfg = validation
    want, ref_arrays = _validate(
        ref_test.run_validation,
        RefCOCODataset(ref_cfg, ref_cfg.data.root, "val2017", is_train=False),
        ref_cfg, ref_pose_net(ref_cfg.model),
        jax.tree.map(jnp.asarray, load_npz_variables(npz)),
        mesh=ref_parallel.make_mesh(2))
    got, arrays = _validate(
        run_validation, COCODataset(cfg, cfg.data.root, "val2017",
                                    is_train=False),
        cfg, pose_net(cfg, npz), device="cpu", mesh=cpu_mesh(2))
    assert got.keys() == want.keys() and len(got) == 10
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    np.testing.assert_array_equal(arrays["image_id"], ref_arrays["image_id"])
    np.testing.assert_allclose(arrays["preds"], ref_arrays["preds"],
                               atol=1e-3, rtol=0)
    for k in ("maxvals", "scores"):
        np.testing.assert_allclose(arrays[k], ref_arrays[k], rtol=1e-5,
                                   atol=1e-9, err_msg=k)
