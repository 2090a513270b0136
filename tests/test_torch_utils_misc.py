"""The port's side utilities against the JAX package's, on the CPU:
utils/vistools.py (a copy: the same bytes, arrays and files out of the same
inputs, through its matplotlib and PIL fallbacks) and utils/profiling.py
(stage_timer prints what JAX's prints; device_trace writes a torch.profiler
Chrome trace where JAX's writes a jax.profiler one).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from sat_bundleadjust_tpu.utils import profiling as jprof
from sat_bundleadjust_tpu.utils import vistools as jvis

from sat_bundleadjust_tpu_torch.utils import profiling as tprof
from sat_bundleadjust_tpu_torch.utils import vistools as tvis


def _image(seed=0, shape=(24, 32)):
    return np.random.RandomState(seed).rand(*shape) * 300.0 - 20.0


def test_to_uint8_and_jpeg_bytes_equal_jax():
    """_to_uint8, the JPEG data URL and show_array's bytes: equal."""
    a = _image()
    np.testing.assert_array_equal(tvis._to_uint8(a), jvis._to_uint8(a))
    np.testing.assert_array_equal(tvis._to_uint8(np.ones((4, 4))), jvis._to_uint8(np.ones((4, 4))))
    assert tvis.urlencoded_jpeg_img(a) == jvis.urlencoded_jpeg_img(a)
    data = tvis.show_array(a)
    assert data == jvis.show_array(a) and data[:2] == b"\xff\xd8"
    assert tvis.show_array(a, fmt="png") == jvis.show_array(a, fmt="png")


@pytest.mark.parametrize("name", ["display_gallery", "display_imshow", "display_cloud",
                                  "overlaymap"])
def test_figures_written_as_jax_writes_them(tmp_path, name):
    """Each figure helper writes a non-empty file of the same pixel size as
    JAX's from the same inputs (the Agg backend)."""
    from PIL import Image

    ims = [np.random.RandomState(i).rand(20, 30) for i in range(5)]
    xyz = np.random.RandomState(0).randn(500, 3)
    ring = np.array([[2.0, 48.0], [2.1, 48.0], [2.1, 48.1], [2.0, 48.1]])
    aoi = [{"coordinates": [ring.tolist()], "center": [2.05, 48.05]}]
    sizes = []
    for mod, tag in ((tvis, "t"), (jvis, "j")):
        path = str(tmp_path / "{}_{}.png".format(name, tag))
        if name == "display_gallery":
            out = mod.display_gallery(ims, titles=list("abcde"), path=path)
        elif name == "display_imshow":
            out = mod.display_imshow(ims[0], range=(0, 1), invert=True, path=path)
        elif name == "display_cloud":
            out = mod.display_cloud(xyz, path=path, max_points=300)
        else:
            m = mod.overlaymap(aoi)
            assert len(m.polygons) == 1
            out = m.show(path=path)
        assert out == path and os.path.getsize(path) > 0
        sizes.append(Image.open(path).size)
    assert sizes[0] == sizes[1]


def test_overprint_text_and_prints_equal_jax(tmp_path, capsys):
    from PIL import Image

    src = str(tmp_path / "src.png")
    Image.fromarray(np.zeros((30, 80), np.uint8)).save(src)
    outs = []
    for mod, tag in ((tvis, "t"), (jvis, "j")):
        dst = str(tmp_path / "dst_{}.png".format(tag))
        mod.overprintText(src, dst, "hello")
        outs.append(np.asarray(Image.open(dst)))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].max() > 0
    capsys.readouterr()
    tvis.printbf("bold")
    t_out = capsys.readouterr().out
    jvis.printbf("bold")
    assert t_out == capsys.readouterr().out


def test_stage_timer_prints_what_jax_prints(capsys, monkeypatch):
    """The same line for the same elapsed time (time.time stubbed: 1.5 s)."""
    outs = []
    for mod in (tprof, jprof):
        ticks = [100.0, 101.5, 0.0, 1.0]
        monkeypatch.setattr(mod.time, "time", lambda: ticks.pop(0))
        with mod.stage_timer("matching"):
            pass
        with mod.stage_timer("quiet", verbose=False):
            pass
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == "matching done in 1.50 seconds\n"


def test_device_trace_writes_a_trace_when_asked(tmp_path, monkeypatch):
    """With SATBA_PROFILE_DIR set: a Chrome trace under <dir>/<name>/ that
    holds the region's operators. Without it: nothing is written."""
    monkeypatch.delenv("SATBA_PROFILE_DIR", raising=False)
    with tprof.device_trace("off"):
        torch.ones(8).sum()
    assert not os.listdir(str(tmp_path))

    monkeypatch.setenv("SATBA_PROFILE_DIR", str(tmp_path))
    with tprof.device_trace("ba_solve"):
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    files = glob.glob(str(tmp_path / "ba_solve" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
