"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import sat_bundleadjust_tpu_torch

PKG_DIR = os.path.dirname(os.path.abspath(sat_bundleadjust_tpu_torch.__file__))
REPO = os.path.dirname(PKG_DIR)


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "sat_bundleadjust_tpu"


def _port_sources():
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", [os.path.join(REPO, "chip_smoke.py"),
                                  os.path.join(REPO, "examples", "synthetic_demo_torch.py")]
                         + sorted(_port_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    """An AST scan of every module of the port (and of chip_smoke.py and the
    port's demo): no import of jax, jaxlib or sat_bundleadjust_tpu, at any
    depth."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, "{} imports {}".format(os.path.relpath(path, REPO), bad)


def test_scan_covers_the_parallel_package():
    """The multi-device modules are among the scanned and imported ones."""
    names = {os.path.relpath(p, PKG_DIR) for p in _port_sources()}
    for m in ("mesh", "multihost", "dist_solver", "feature_shard"):
        assert os.path.join("parallel", m + ".py") in names, m


def test_import_leaves_jax_unloaded():
    """Importing every module of the port in a fresh interpreter loads no
    jax module."""
    mods = sorted(
        "sat_bundleadjust_tpu_torch." + os.path.relpath(p, PKG_DIR)[:-3].replace(os.sep, ".")
        for p in _port_sources() if not p.endswith("__init__.py"))
    code = ("import sys\nimport sat_bundleadjust_tpu_torch\n"
            + "".join("import {}\n".format(m) for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
              "'sat_bundleadjust_tpu')]\nassert not bad, bad\nprint('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_precision_pins():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_default_to_the_card():
    """Called without device=, an entry point asks for CUDA; on a host
    without it, it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    from sat_bundleadjust_tpu_torch.ba import outliers, solver
    from sat_bundleadjust_tpu_torch.utils import demo

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sat_bundleadjust_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.make_scene_arrays(n_cam=4, n_pts=20)
    scene = demo.make_scene_arrays(n_cam=4, n_pts=20, device="cpu")
    p = demo.scene_to_baparams(scene)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solver.run_ba_optimization(p, {"max_iter": 1})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        outliers.rm_outliers(p.pts2d[:, 0] * 0.0, p)
    assert sat_bundleadjust_tpu_torch.resolve_device("cpu") == torch.device("cpu")
