"""The PyTorch/CUDA port stands alone: no module of ``cekirdekler_tpu_torch``,
and not ``chip_smoke.py``, imports ``jax`` or any module of the JAX package.

Two checks: an AST scan of every source file (static, per file), and a
child interpreter that blocks ``jax`` and ``cekirdekler_tpu`` through a
``sys.meta_path`` hook and then imports every module of the port (what
really gets imported, whatever the source spells).  The child also drives
``chip_smoke.main()`` on this card-less machine: it must refuse with a
non-zero code and print no result line.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cekirdekler_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "cekirdekler_tpu")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imported_names(path: Path) -> list[str]:
    """Every absolute module name the file imports, plus constant strings
    handed to ``importlib.import_module`` / ``__import__``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out: list[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                out.append(node.module)
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(arg, ast.Constant):
                out.append(str(arg.value))
    return out


def _relative_escapes(path: Path) -> list[str]:
    """Relative imports that climb out of the port package."""
    depth = len(path.relative_to(PORT).parts) - 1 if PORT in path.parents else -1
    tree = ast.parse(path.read_text(), filename=str(path))
    return [f"{'.' * n.level}{n.module or ''}" for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level > depth + 1]


def test_port_has_sources():
    assert len(FILES) > 15, FILES
    for name in ("mandelbrot.cu", "flash_attention.cu", "flash_attention_tc.cu",
                 "flash_attention_bwd.cu", "flash_attention_bwd_tc.cu", "elementwise.cu"):
        assert (PORT / "csrc" / name).is_file(), name


@pytest.mark.parametrize("name", ["mesh.py", "collectives.py", "attention.py"])
def test_parallel_modules_are_scanned(name):
    """The sequence-parallel tier's modules are among the scanned files
    and import torch, not JAX."""
    path = PORT / "parallel" / name
    assert path in FILES
    names = _imported_names(path)
    assert "torch" in names and not any(_forbidden(m) for m in names)


@pytest.mark.parametrize("name", ["obs/health.py", "obs/drain.py", "trace/attribution.py",
                                  "trace/export.py", "trace/device.py", "utils/timeline.py"])
def test_observability_modules_are_scanned_and_import_no_torch_at_load(name):
    """The health, drain and device-timeline modules are among the scanned
    files, import no JAX, and import torch only inside the functions that
    use it (a module-level import would tie the planes to torch's load)."""
    path = PORT / name
    assert path in FILES
    assert not any(_forbidden(m) for m in _imported_names(path))
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [a.name for n in tree.body if isinstance(n, ast.Import) for a in n.names]
    top += [n.module or "" for n in tree.body if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not any(m.split(".")[0] == "torch" for m in top), top


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = [m for m in _imported_names(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"
    assert _relative_escapes(path) == [], f"{path.relative_to(ROOT)} imports outside the port"


_CHILD = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "cekirdekler_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import cekirdekler_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cekirdekler_tpu_torch.__path__,
                                                "cekirdekler_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
rc = chip_smoke.main()
assert rc != 0, rc
leaked = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "cekirdekler_tpu"))
assert not leaked, leaked
print("IMPORTED", len(names))
"""


def _child_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_whole_port_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=_child_env(),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("IMPORTED", 1)[1].split()[0])
    assert n >= 15
    # the refusal goes to stderr; no result line reaches stdout
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """From a directory that holds ``chip_smoke.py`` and nothing else of
    the repo, the script must exit non-zero and print no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _child_env()
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


OBS_SLICE = ("analysis", "analysis.model", "obs.reqtrace", "obs.debugserver",
             "utils.checkpoint", "tools.ckprove")


@pytest.mark.parametrize("name", OBS_SLICE)
def test_observability_slice_modules_are_scanned(name):
    """The verifier, the model checker, request tracing, the debug server,
    checkpoints and the ckprove CLI are among the scanned files and import
    no JAX and nothing of the JAX package."""
    parts = name.split(".")
    path = PORT.joinpath(*parts[:-1], parts[-1] + ".py")
    if not path.is_file():
        path = PORT.joinpath(*parts, "__init__.py")
    assert path in FILES
    assert not any(_forbidden(m) for m in _imported_names(path))
    assert _relative_escapes(path) == []


_SLICE_CHILD = r"""
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cekirdekler_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module("cekirdekler_tpu_torch." + name)
from cekirdekler_tpu_torch.analysis import model
model.check_machine("drain", quick=True)
from cekirdekler_tpu_torch.tools import ckprove
assert ckprove.main([]) == 0
leaked = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "cekirdekler_tpu"))
assert not leaked, leaked
print("SLICE OK")
"""


def test_observability_slice_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _SLICE_CHILD, *OBS_SLICE], cwd=ROOT,
                          env=_child_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SLICE OK" in proc.stdout and "ckprove: clean" in proc.stdout


@pytest.mark.parametrize("name", ["utils/markers.py", "utils/events.py"])
def test_marker_and_event_modules_are_pure_python(name):
    """Queue markers and user events are among the scanned files and import
    neither JAX, nor anything of the JAX package, nor torch, nor a native
    library (``ctypes``): the reference's pure-Python paths."""
    path = PORT / name
    assert path in FILES
    names = _imported_names(path)
    assert not any(_forbidden(m) for m in names)
    assert not any(m.split(".")[0] in ("torch", "ctypes") for m in names), names
    assert _relative_escapes(path) == []


CLUSTER_SLICE = ("cluster", "cluster.netbuffer", "cluster.balancer", "cluster.server",
                 "cluster.client", "cluster.accelerator", "cluster.elastic", "cluster.dcn",
                 "trace.aggregate", "tools.dcn_cluster")


@pytest.mark.parametrize("name", CLUSTER_SLICE)
def test_cluster_slice_modules_are_scanned(name):
    """The cluster tier, trace aggregation and the DCN tool are among the
    scanned files and import no JAX and nothing of the JAX package (their
    own copies of the reference's jax-free modules included)."""
    parts = name.split(".")
    path = PORT.joinpath(*parts[:-1], parts[-1] + ".py")
    if not path.is_file():
        path = PORT.joinpath(*parts, "__init__.py")
    assert path in FILES
    assert not any(_forbidden(m) for m in _imported_names(path))
    assert _relative_escapes(path) == []


_CLUSTER_CHILD = r"""
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cekirdekler_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module("cekirdekler_tpu_torch." + name)
import numpy as np
from cekirdekler_tpu_torch.analysis import model
from cekirdekler_tpu_torch.cluster import ClusterLoadBalancer, Command, Message
from cekirdekler_tpu_torch.cluster.netbuffer import ArrayRecord
assert model.check_machine("elastic", quick=True)["violations"] == []
msg = Message(Command.COMPUTE, meta={"a": 1}, arrays=[ArrayRecord(1, np.arange(3.0))])
assert Message.decode(msg.command, msg.encode()).meta == {"a": 1}
assert ClusterLoadBalancer([64, 128]).equal_split(1024)[1] == 0
leaked = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "cekirdekler_tpu"))
assert not leaked, leaked
print("CLUSTER OK")
"""


def test_cluster_slice_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _CLUSTER_CHILD, *CLUSTER_SLICE], cwd=ROOT,
                          env=_child_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLUSTER OK" in proc.stdout
