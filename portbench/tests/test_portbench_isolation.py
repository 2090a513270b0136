"""What the harness and the reference load: no module whose top-level name
is jax, jaxlib, flax or sat_bundleadjust_tpu (names compared whole: the
port, sat_bundleadjust_tpu_torch, begins with the JAX package's name), and
in the reference and the frozen scenes nothing of the port either. Each
check runs in a fresh interpreter."""

import json
import os
import subprocess
import sys

from portbench import run as runm
from portbench import spec as specm

REFERENCE = ["portbench.reference.ba_lm", "portbench.reference.cli_outputs", "portbench.faults",
             "portbench.scenes.generate", "portbench.scenes.rpc", "portbench.counts",
             "portbench.peaks", "portbench.window", "portbench.trace"]


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=specm.ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=specm.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_reference_and_the_scenes_load_nothing_of_the_port_or_of_jax():
    loaded = _loaded("\n".join("import " + m for m in REFERENCE))
    assert not loaded & set(runm.FORBIDDEN), loaded & set(runm.FORBIDDEN)
    assert "sat_bundleadjust_tpu_torch" not in loaded


def test_whole_runs_of_every_cell_load_no_jax():
    # both cells end to end on the CPU at the test sizes, in one interpreter
    code = ("import tempfile, torch, pytest\n"
            "from portbench import run\n"
            "from portbench.tests import tiny\n"
            "mp = pytest.MonkeyPatch(); tiny.on_the_cpu(mp)\n"
            "spec = tiny.tiny_spec(tempfile.mkdtemp())\n"
            "for w in [c['name'] for c in spec.bench['workloads']]:\n"
            "    assert run.run(w, 3, 0.1, 0, spec=spec, device=torch.device('cpu'))['attempted']\n"
            "import portbench.readings\n")
    loaded = _loaded(code)
    assert "sat_bundleadjust_tpu_torch" in loaded
    assert not loaded & set(runm.FORBIDDEN), loaded & set(runm.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sat_bundleadjust_tpu_torch_x", sys)
    assert "sat_bundleadjust_tpu" not in runm.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sat_bundleadjust_tpu.ops", sys)
    assert "sat_bundleadjust_tpu" in runm.forbidden_modules()
