"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared by their
top-level part, whole: the port, ``flowtrack_tpu_torch``, begins with the
JAX package's name."""

import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "flowtrack_tpu")


def imported(modules, extra=""):
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"{extra}"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def modules():
    names = []
    for p in sorted((ROOT / "portbench").rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or "metrics" in rel.parts:
            continue
        names.append(".".join(rel.parts).removesuffix(".__init__"))
    return names


def test_the_benchmark_imports_neither_jax_nor_the_jax_package():
    readers = "".join(
        f"spec.reader({p.stem!r})\n"
        for p in sorted((ROOT / "portbench" / "metrics").glob("*.py")))
    extra = ("from portbench import spec\n" + readers
             + "import flowtrack_tpu_torch.serving\n"
             "import flowtrack_tpu_torch.tracking.clip_pipeline\n")
    loaded = imported(modules(), extra)
    assert not loaded & set(FORBIDDEN)
    assert "flowtrack_tpu_torch" in loaded


def test_the_reference_imports_nothing_of_the_program():
    loaded = imported(["portbench.reference.nets", "portbench.reference.ops",
                       "portbench.reference.pose_resnet",
                       "portbench.reference.flownet",
                       "portbench.reference.clip", "portbench.check",
                       "portbench.counts", "portbench.control"])
    assert not loaded & set(FORBIDDEN + ("flowtrack_tpu_torch",))


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "flowtrack_tpu.config", object())
    assert run.forbidden_modules() == ["flowtrack_tpu"]
    monkeypatch.delitem(sys.modules, "flowtrack_tpu.config")
    monkeypatch.setitem(sys.modules, "flowtrack_tpu_torch.x", object())
    assert run.forbidden_modules() == []
