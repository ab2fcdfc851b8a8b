"""The port's boundaries: no jax, nothing of the reference package and no
cv2 in its imports or its smoke's (the training modules' included), its
config one for one with the reference's, no CPU fallback for CUDA.

These run on a machine without CUDA, where every CUDA entry point must
refuse with RuntimeError instead of running the plain versions on the CPU,
while CPU tensors take the plain versions and launch nothing.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowtrack_tpu import config as ref_config
from flowtrack_tpu.config import Config
from flowtrack_tpu_torch import config as port_config
from flowtrack_tpu_torch import kernels
from flowtrack_tpu_torch.ops import correlation as tcorr
from flowtrack_tpu_torch.ops import crop as tcrop
from flowtrack_tpu_torch.ops import warp as twarp
from flowtrack_tpu_torch.tracking.clip_pipeline import ClipTracker

REPO = Path(__file__).resolve().parents[1]
PORT_MODULES = ["flowtrack_tpu_torch"] + sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (REPO / "flowtrack_tpu_torch").rglob("*.py"))


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port (and runs its
    CPU path once) without jax, flax, optax or cv2 entering sys.modules:
    the card's machine has none of them, and the video readers import cv2
    only when they read a file."""
    code = (
        "import importlib, sys\n"
        f"mods = {PORT_MODULES!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "from flowtrack_tpu_torch.ops.crop import crop_resize_normalize\n"
        "crop_resize_normalize(torch.zeros(8, 8, 3), torch.ones(1, 2),\n"
        "                      torch.ones(1, 2), (4, 4))\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                    'cv2'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(PORT_MODULES) >= 20
    for mod in ("flowtrack_tpu_torch.serving", "flowtrack_tpu_torch.utils.video",
                "flowtrack_tpu_torch.data.pose_dataset",
                "flowtrack_tpu_torch.pipeline",
                "flowtrack_tpu_torch.data.coco", "flowtrack_tpu_torch.data.coco_io",
                "flowtrack_tpu_torch.data.loader",
                "flowtrack_tpu_torch.data.flow_dataset",
                "flowtrack_tpu_torch.eval.flow_eval",
                "flowtrack_tpu_torch.engine.loss",
                "flowtrack_tpu_torch.engine.metrics",
                "flowtrack_tpu_torch.engine.train",
                "flowtrack_tpu_torch.engine.flow_train",
                "flowtrack_tpu_torch.engine.checkpoint",
                "flowtrack_tpu_torch.eval.coco_eval",
                "flowtrack_tpu_torch.eval.posetrack_eval",
                "flowtrack_tpu_torch.data.posetrack",
                "flowtrack_tpu_torch.data.mpii",
                "flowtrack_tpu_torch.utils.vis",
                "flowtrack_tpu_torch.utils.logging",
                "flowtrack_tpu_torch.native",
                "flowtrack_tpu_torch.tools.common",
                "flowtrack_tpu_torch.tools.test",
                "flowtrack_tpu_torch.tools.track",
                "flowtrack_tpu_torch.tools.track_video",
                "flowtrack_tpu_torch.tools.demo",
                "flowtrack_tpu_torch.tools.eval_flow",
                "flowtrack_tpu_torch.tools.train",
                "flowtrack_tpu_torch.tools.train_flow",
                "flowtrack_tpu_torch.utils.graphs",
                "flowtrack_tpu_torch.parallel",
                "flowtrack_tpu_torch.parallel.mesh",
                "flowtrack_tpu_torch.parallel.distributed"):
        assert mod in PORT_MODULES, mod
    assert proc.stdout.split()[0] == str(len(PORT_MODULES))


def test_port_and_smoke_import_nothing_of_the_reference():
    """A fresh interpreter imports every module of the port and chip_smoke,
    and builds the smoke's configs, without a module of the reference
    package ``flowtrack_tpu`` entering sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke.flownet2_config()\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('flowtrack_tpu', 'jax', 'jaxlib',\n"
        "                                    'flax', 'optax', 'cv2'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("section", ["model", "flow", "train", "test", "track",
                                     "data", "mesh"])
def test_port_config_sections_match_reference(section):
    """Each section the port keeps has the reference's field names, types
    and defaults, in the same order."""
    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    port_cls = type(getattr(port_config.Config(), section))
    ref_cls = type(getattr(ref_config.Config(), section))
    assert port_cls.__name__ == ref_cls.__name__
    assert spec(port_cls) == spec(ref_cls)
    assert [f.name for f in dataclasses.fields(port_config.Config)] == [
        f.name for f in dataclasses.fields(ref_config.Config)] == [
        "name", "model", "flow", "train", "test", "track", "data", "mesh"]
    for name in ("COCO_NUM_JOINTS", "COCO_FLIP_PAIRS", "COCO_SIGMAS",
                 "MPII_NUM_JOINTS", "MPII_FLIP_PAIRS", "PIXEL_STD", "IMAGENET_MEAN",
                 "IMAGENET_STD"):
        assert getattr(port_config, name) == getattr(ref_config, name), name


@pytest.mark.parametrize("name", sorted(ref_config.PRESETS))
def test_port_presets_match_reference(name):
    """Every reference preset is in the port, equal field for field in each
    section, the mesh's included; an unknown name raises KeyError."""
    got, want = port_config.get_config(name), ref_config.get_config(name)
    assert got.name == want.name
    for section in ("model", "flow", "train", "test", "track", "data",
                    "mesh"):
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(want, section)), section
    assert sorted(port_config.PRESETS) == sorted(ref_config.PRESETS)
    with pytest.raises(KeyError):
        port_config.get_config(name + "_x")


def test_port_overrides_match_reference():
    """The CLIs' dotted overrides: the same coercions (bool, int, float,
    tuple, str) give the same sections, the mesh's included; a key that
    neither has raises in both."""
    opts = ["test.flip_test=false", "model.num_layers=18",
            "model.image_size=64,48", "track.box_expand=0.2",
            "flow.variant=flownet_c", "TEST.IN_VIS_THRE=0.3",
            "data.root=/data/x", "track.clip_recover=1",
            "mesh.num_devices=2", "mesh.data_axis=batch"]
    got = port_config.apply_overrides(port_config.get_config(
        "flowtrack_posetrack"), opts)
    want = ref_config.apply_overrides(ref_config.get_config(
        "flowtrack_posetrack"), opts)
    for section in ("model", "flow", "train", "test", "track", "data",
                    "mesh"):
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(want, section)), section
    assert got.model.image_size == (64, 48) and not got.test.flip_test
    assert got.mesh == port_config.MeshConfig("batch", 2)
    for apply, cfg in ((port_config.apply_overrides, port_config.Config()),
                       (ref_config.apply_overrides, ref_config.Config())):
        with pytest.raises(AttributeError):
            apply(cfg, ["mesh.num_chips=2"])


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (REPO / "experiments").glob("*.yaml")))
def test_port_load_yaml_matches_reference(path):
    """Each experiment file gives the reference's config through the
    port's own YAML reader (no PyYAML on the card's machine), also by
    get_config; the reader gives PyYAML's mapping."""
    import yaml

    full = REPO / path
    got = port_config.get_config(str(full))
    want = ref_config.load_yaml(str(full))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    text = full.read_text()
    assert port_config.parse_yaml(text) == yaml.safe_load(text)


def test_port_ships_with_the_package_config():
    """The port is a namespace package (no top-level ``__init__.py``), so
    ``find_packages`` with pyproject's ``flowtrack_tpu*`` still finds only
    the reference, while the pyproject build, which finds namespace packages
    by default, ships the port's subpackages and its CUDA sources."""
    import tomllib

    from setuptools import find_namespace_packages, find_packages

    with open(REPO / "pyproject.toml", "rb") as f:
        setup = tomllib.load(f)["tool"]["setuptools"]
    find = setup["packages"]["find"]
    assert find.get("namespaces", True)
    shipped = find_namespace_packages(where=REPO, include=find["include"])
    for mod in PORT_MODULES:
        pkg = mod if (REPO / mod.replace(".", "/")).is_dir() else \
            mod.rpartition(".")[0]
        assert pkg in shipped, pkg
    assert not any(p.startswith("flowtrack_tpu_torch")
                   for p in find_packages(where=REPO, include=find["include"]))
    assert setup["package-data"]["flowtrack_tpu_torch"] == ["csrc/*.cu"]


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_clip_tracker_on_cuda_raises_without_cuda():
    _require_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        ClipTracker(Config(), torch.nn.Identity(), torch.nn.Identity(),
                    device="cuda")


def test_serving_entry_points_on_cuda_raise_without_cuda():
    """PosePredictor, FlowPredictor and FlowTracker take 'cuda' by default
    and refuse without a CUDA device; the serving classes run on a
    ClipTracker, which refuses the same way."""
    from flowtrack_tpu_torch.pipeline import FlowPredictor, PosePredictor
    from flowtrack_tpu_torch.tracking import FlowTracker

    _require_no_cuda()
    for make in (lambda: PosePredictor(Config(), torch.nn.Identity()),
                 lambda: FlowPredictor(Config(), torch.nn.Identity()),
                 lambda: FlowTracker(Config(), lambda *a: None),
                 lambda: ClipTracker(Config(), torch.nn.Identity(),
                                     torch.nn.Identity())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # on the CPU when asked
    assert FlowTracker(Config(), lambda *a: None, device="cpu").device.type \
        == "cpu"


def test_compiled_entry_points_keep_the_reference_signatures():
    """The reference's jitted entry points that the port replays as CUDA
    graphs keep their signatures: ``make_jit_train_step``, and the
    per-frame engine's ``PosePredictor`` (``max_persons``),
    ``nms_boxes_padded`` and ``propagate_and_boxes``."""
    import inspect

    from flowtrack_tpu import pipeline as ref_pipeline
    from flowtrack_tpu.engine import train as ref_train
    from flowtrack_tpu.tracking import tracker as ref_tracker
    from flowtrack_tpu_torch import pipeline
    from flowtrack_tpu_torch.engine import train
    from flowtrack_tpu_torch.tracking import tracker

    def params(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(train.make_jit_train_step) == params(
        ref_train.make_jit_train_step)
    for name in ("nms_boxes_padded", "propagate_and_boxes",
                 "match_propagated"):
        assert [n for n, _ in params(getattr(tracker, name))] == [
            n for n, _ in params(getattr(ref_tracker, name))], name
    assert ("max_persons", None) in params(pipeline.PosePredictor) and \
        ("max_persons", None) in params(ref_pipeline.PosePredictor)


def test_kernel_loader_raises_without_cuda():
    """Asked to build or load, the loader refuses; it never hands back the
    plain versions."""
    _require_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA device"):
        kernels.build()
    with pytest.raises(RuntimeError, match="CUDA device"):
        kernels.library()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; they do not fall back."""
    with pytest.raises(RuntimeError, match="CUDA"):
        tcrop.crop_frames_cuda(torch.zeros(1, 8, 8, 3),
                               torch.zeros(1, dtype=torch.int32),
                               torch.ones(1, 2), torch.ones(1, 2), (4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcorr.correlation_cuda(torch.zeros(1, 4, 5, 5), torch.zeros(1, 4, 5, 5),
                               2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        twarp.resample2d_cuda(torch.zeros(1, 3, 5, 5), torch.zeros(1, 2, 5, 5))


def test_cpu_tensors_take_the_plain_versions():
    """Dispatch by device: CPU tensors give the plain results and count no
    kernel launch."""
    before = (tcrop.crop_frames_cuda.launches,
              tcorr.correlation_cuda.launches,
              twarp.resample2d_cuda.launches)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.uniform(0, 255, (2, 16, 20, 3))
                              .astype(np.float32))
    args = (frames, torch.tensor([1, 0]), torch.tensor([[8.0, 8.0]] * 2),
            torch.tensor([[0.06, 0.08]] * 2), (8, 6))
    torch.testing.assert_close(tcrop.crop_frames(*args),
                               tcrop.crop_frames_plain(*args), rtol=0, atol=0)
    f1 = torch.from_numpy(rng.normal(size=(1, 6, 7, 4)).astype(np.float32))
    torch.testing.assert_close(tcorr.correlation(f1, f1, 2, 1),
                               tcorr.correlation_plain(f1, f1, 2, 1),
                               rtol=0, atol=0)
    img = torch.from_numpy(rng.normal(size=(1, 6, 7, 3)).astype(np.float32))
    flow = torch.from_numpy(rng.normal(size=(1, 6, 7, 2)).astype(np.float32))
    torch.testing.assert_close(
        twarp.resample2d(img, flow),
        twarp.resample2d_plain(img.permute(0, 3, 1, 2),
                               flow.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
        rtol=0, atol=0)
    assert (tcrop.crop_frames_cuda.launches,
            tcorr.correlation_cuda.launches,
            twarp.resample2d_cuda.launches) == before


def test_library_path_tracks_the_sources():
    """The built library's name carries the hash of the sources and flags,
    under build/flowtrack_tpu_torch/, so an edited source is rebuilt."""
    path = kernels.library_path()
    assert path.parent == REPO / "build" / "flowtrack_tpu_torch"
    assert path.name.startswith("libflowtrack_kernels_")
    assert set(kernels.SOURCES) == {p.name for p in kernels.CSRC.glob("*.cu")}
    assert set(kernels.HEADERS) == {p.name for p in kernels.CSRC.glob("*.cuh")}


def test_kernel_ab_imports_nothing_of_the_reference():
    """The old-against-new timing script imports the port and chip_smoke
    only."""
    code = ("import sys\nimport kernel_ab\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('flowtrack_tpu', 'jax', 'jaxlib', 'flax', 'optax'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_library_path_tracks_the_flags(monkeypatch):
    """Another set of nvcc flags names another library."""
    plain = kernels.library_path()
    monkeypatch.setattr(kernels, "NVCC_FLAGS",
                        kernels.NVCC_FLAGS + ("-lineinfo",))
    assert kernels.library_path() != plain


def test_sources_ship_with_the_package_config():
    """An installed package can build its kernels and its host NMS:
    pyproject ships the CUDA sources, their header and the NMS source,
    each key a package whose files the globs find."""
    import fnmatch
    import tomllib

    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    wanted = {"flowtrack_tpu_torch": ["crop.cu", "correlation.cu",
                                      "resample2d.cu", "fused_stage.cu"],
              "flowtrack_tpu_torch.csrc": ["hopper.cuh"],
              "flowtrack_tpu_torch.native": ["nms.cc"]}
    for pkg, names in wanted.items():
        root = REPO / pkg.replace(".", "/")
        shipped = {str(p.relative_to(root)) for glob in data[pkg]
                   for p in root.glob(glob)}
        for name in names:
            assert any(fnmatch.fnmatch(s, f"*{name}") for s in shipped), \
                (pkg, name)


def test_build_dir_falls_back_to_the_user_cache(tmp_path, monkeypatch):
    """The kernels and the host NMS build beside the checkout when that can
    be written, and in the user's cache directory when it cannot (an
    installed package); nothing is built to find out."""
    from flowtrack_tpu_torch import native

    assert kernels.BUILD_DIR == kernels.build_dir()
    assert native.library_path().parent == kernels.BUILD_DIR
    writable = tmp_path / "checkout" / "build" / "flowtrack_tpu_torch"
    assert kernels.build_dir(writable) == writable
    blocked = tmp_path / "a_file"
    blocked.write_text("")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert (kernels.build_dir(blocked / "build" / "flowtrack_tpu_torch")
            == tmp_path / "cache" / "flowtrack_tpu_torch")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert (kernels.build_dir(blocked / "build")
            == tmp_path / "home" / ".cache" / "flowtrack_tpu_torch")
    assert not any(tmp_path.glob("**/*.so"))
